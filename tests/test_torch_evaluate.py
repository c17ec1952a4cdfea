"""The port's evaluation (etude_tpu_torch/evaluate.py, evaluation/) against
the JAX package's (the root evaluate.py, etude_tpu/evaluation/), on the CPU.

Held: WPD, RGC and IPE within 1e-9 (the same numpy arithmetic; measured
equal), and the same error results; the port's k-means labels equal to
scikit-learn's `KMeans(random_state=42, n_init="auto")` (so the partitions
are equal); the runner's rows equal to the JAX DataFrame's records (None
where it holds NaN); the CSV text equal to `df.to_csv(index=False)`; the
report's numbers equal to pandas `describe()` and the combined means to
1e-12 relative (pandas and numpy sum in other orders).
"""

import json
import math
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.exceptions import ConvergenceWarning

from etude_tpu.config import load_config as jax_load_config
from etude_tpu.evaluation import metrics as jax_metrics
from etude_tpu.evaluation.runner import EvaluationRunner as JaxRunner
from etude_tpu_torch import evaluate
from etude_tpu_torch.config import load_config
from etude_tpu_torch.evaluation import metrics
from etude_tpu_torch.evaluation.metrics.ipe import kmeans_labels
from etude_tpu_torch.evaluation.reporting import ReportGenerator
from etude_tpu_torch.evaluation.runner import EvaluationRunner, write_csv
from etude_tpu_torch.utils.audio import save_wav
from etude_tpu_torch.utils.midi import write_midi
from test_torch_align import piano_pair

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import evaluate as jax_evaluate  # noqa: E402  (the root CLI)

METRIC_ATOL = 1e-9


def _onsets(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "grid":      # a tempo grid with a few subdivisions
        steps = rng.choice([0.25, 0.5, 0.125, 0.375], size=120)
    elif kind == "jitter":  # the same with performance timing
        steps = rng.choice([0.25, 0.5], size=120) + rng.normal(0, 0.01, size=120)
    elif kind == "free":
        steps = rng.exponential(0.3, size=120)
    elif kind == "few":     # two distinct IOIs, ties everywhere
        steps = rng.choice([0.25, 0.5], size=12)
    elif kind == "short":   # fewer IOIs than the n-gram
        steps = rng.uniform(0.1, 1.0, size=5)
    else:                   # one IOI: RGC and IPE cannot score it
        steps = np.full(30, 0.5)
    return np.concatenate([[0.2], 0.2 + np.cumsum(np.abs(steps) + 1e-3)])


def _notes(onsets, seed):
    rng = np.random.default_rng(seed)
    return [{"onset": float(t), "offset": float(t + 0.2), "pitch": int(rng.integers(40, 90)),
             "velocity": int(rng.integers(30, 120))} for t in onsets]


def _assert_results_close(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, abs=METRIC_ATOL, rel=0), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("kind", ["grid", "jitter", "free", "few", "short", "one"])
@pytest.mark.parametrize("suffix", [".json", ".mid"])
def test_rgc_and_ipe_equal_jax(tmp_path, kind, suffix):
    notes = _notes(_onsets(kind, seed=len(kind)), seed=3)
    path = tmp_path / f"v{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(notes))
    else:
        write_midi(notes, path)
    for ours, theirs in ((metrics.RGCCalculator(top_k=8), jax_metrics.RGCCalculator(top_k=8)),
                         (metrics.IPECalculator(n_gram=8, n_clusters=16),
                          jax_metrics.IPECalculator(n_gram=8, n_clusters=16)),
                         (metrics.IPECalculator(n_gram=3, n_clusters=4),
                          jax_metrics.IPECalculator(n_gram=3, n_clusters=4))):
        _assert_results_close(ours.calculate(path), theirs.calculate(path))
    assert metrics.get_onsets_from_file(tmp_path / "missing.json").size == 0


@pytest.mark.parametrize("step,trim", [(1, 0), (3, 0), (1, 2)])
def test_wpd_equals_jax(step, trim):
    rng = np.random.default_rng(step + trim)
    n = 600
    cover = np.cumsum(rng.integers(1, 3, size=n))
    origin = np.cumsum(rng.integers(1, 3, size=n))
    align = {"wp": np.stack([cover, origin]), "num_frames_cover": int(cover[-1]) - 5,
             "num_frames_origin": int(origin[-1]) + 1}
    got = metrics.WPDCalculator(subsample_step=step, trim_seconds=trim).calculate(align)
    want = jax_metrics.WPDCalculator(subsample_step=step, trim_seconds=trim).calculate(align)
    _assert_results_close(got, want)
    short = {**align, "wp": align["wp"][:, :5]}
    assert metrics.WPDCalculator().calculate(short) == jax_metrics.WPDCalculator().calculate(short)
    assert "error" in metrics.WPDCalculator().calculate({"wp": align["wp"]})
    with pytest.raises(ValueError):
        metrics.WPDCalculator(subsample_step=0)


def _log_iois(kind, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 600))
    if kind == "uniform":
        iois = rng.uniform(0.0625, 4.0, size=n)
    elif kind == "grid":
        iois = rng.choice([0.125, 0.25, 0.375, 0.5, 1.0], size=n)
    elif kind == "rounded":
        iois = np.round(rng.exponential(0.3, size=n) / 0.05) * 0.05
    elif kind == "near_ties":
        iois = rng.choice([0.25, 0.5], size=n) + rng.normal(0, 1e-3, size=n)
    else:   # mostly one value: fewer distinct values than clusters
        iois = np.full(n, 0.25)
        iois[rng.integers(0, n, size=3)] = 0.5
    return np.log(np.clip(iois, 0.0625, 4.0)).reshape(-1, 1)


@pytest.mark.parametrize("kind", ["uniform", "grid", "rounded", "near_ties", "few_values"])
def test_kmeans_labels_equal_sklearn(kind):
    """12 seeded IOI sets per kind, each at k = 16, 8 and 3 (capped at the
    number of distinct values): 60 sets in all."""
    cases = 0
    for seed in range(12):
        x = _log_iois(kind, 100 * seed + len(kind))
        for n_clusters in (16, 8, 3):
            k = min(n_clusters, len(np.unique(x)))
            if k < 2:
                continue
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", category=ConvergenceWarning)
                want = KMeans(n_clusters=k, random_state=42, n_init="auto").fit(x).labels_
            np.testing.assert_array_equal(kmeans_labels(x, k), want,
                                          err_msg=f"seed {seed}, k {k}")
            cases += 1
    assert cases >= 24


def _eval_corpus(root: Path):
    """Two songs: origin.wav; `human` = a cover render with its notes as
    .json; `etude_e` = another render with a .mid; `picogen` = a .mid
    only (no audio, so no WPD); `amtapc` = nothing."""
    meta = []
    for k, (seed, transpose) in enumerate(((0, 2), (1, -1))):
        song = root / f"song{k}"
        origin, cover = piano_pair(seed, seconds=6.0, transpose=transpose)
        save_wav(song / "origin.wav", origin, 22050)
        save_wav(song / "human.wav", cover, 22050)
        _, other = piano_pair(seed + 10, seconds=6.0, stretch=0.9, transpose=0)
        save_wav(song / "etude_e.wav", other, 22050)
        (song / "human.json").write_text(json.dumps(_notes(_onsets("jitter", seed), seed)))
        write_midi(_notes(_onsets("grid", seed), seed + 1), song / "etude_e.mid")
        write_midi(_notes(_onsets("free", seed), seed + 2), song / "picogen.mid")
        meta.append({"dir_name": song.name})
    meta.append({"dir_name": "absent"})
    (root / "metadata.json").write_text(json.dumps(meta))


def _eval_settings(tmp_path, side, corpus, **eval_extra):
    path = tmp_path / f"{side}.json"
    path.write_text(json.dumps({
        "paths": {"eval_output_dir": str(tmp_path / side / "out")},
        "eval": {"eval_dir": str(corpus), "metadata_path": str(corpus / "metadata.json"),
                 "versions": {"human": "Human", "etude_e": "Etude Extractor",
                              "picogen": "PiCoGen", "amtapc": "AMT-APC"},
                 **eval_extra},
    }))
    return path


def _records(df):
    return [{k: (None if isinstance(v, float) and math.isnan(v) else v) for k, v in r.items()}
            for r in df.to_dict("records")]


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """Both runners on copies of one corpus: (port rows, JAX DataFrame,
    tmp dir)."""
    tmp = tmp_path_factory.mktemp("eval")
    for side in ("jax", "port"):
        _eval_corpus(tmp / side / "corpus")
    df = JaxRunner(jax_load_config(_eval_settings(tmp, "jax", tmp / "jax" / "corpus"))).run()
    rows = EvaluationRunner(load_config(_eval_settings(tmp, "port", tmp / "port" / "corpus")),
                            device="cpu").run()
    return rows, df, tmp


def test_runner_rows_equal_jax(evaluated):
    rows, df, tmp = evaluated
    want = _records(df)
    assert [(r["song"], r["version"]) for r in rows] == [
        (s, v) for s in ("song0", "song1") for v in ("human", "etude_e", "picogen", "amtapc")]
    assert len(rows) == len(want)
    for got, exp in zip(rows, want):
        assert set(got) == set(exp) == {"song", "version", "wpd", "rgc", "ipe"}
        for key, value in exp.items():
            if isinstance(value, float):
                assert got[key] == pytest.approx(value, abs=METRIC_ATOL, rel=0), (got, exp)
            else:
                assert got[key] == value, (got, exp)
    human = [r for r in rows if r["version"] == "human"]
    assert all(r["wpd"] is not None and r["rgc"] is not None and r["ipe"] is not None
               for r in human)
    assert all(r["wpd"] is None for r in rows if r["version"] in ("picogen", "amtapc"))
    # The wp.json caches the two runners wrote are the same.
    for song in ("song0", "song1"):
        assert (json.loads((tmp / "port" / "corpus" / song / "wp.json").read_text())
                == json.loads((tmp / "jax" / "corpus" / song / "wp.json").read_text()))


def test_csv_equals_pandas(evaluated, tmp_path):
    rows, df, _ = evaluated
    want = pd.DataFrame(rows).to_csv(index=False)
    write_csv(rows, tmp_path / "port.csv")
    assert (tmp_path / "port.csv").read_text() == want
    # Rows with a metric missing from some of them, and a song name that
    # must be quoted.
    odd = [{"song": "a,b", "version": "x", "rgc": 0.1},
           {"song": 'c"d', "version": "y", "rgc": None, "ipe": 1e-05}]
    write_csv(odd, tmp_path / "odd.csv")
    assert (tmp_path / "odd.csv").read_text() == pd.DataFrame(odd).to_csv(index=False)


def test_report_numbers_equal_pandas(evaluated):
    rows, df, _ = evaluated
    labels = {"human": "Human", "etude_e": "Etude Extractor", "picogen": "PiCoGen"}
    report = ReportGenerator(labels)
    tables = report.summary(rows)
    assert list(tables) == ["wpd", "rgc", "ipe"]
    for metric, table in tables.items():
        want = (df.groupby("version")[metric].astype(float).describe()
                if df[metric].dtype == object else df.groupby("version")[metric].describe())
        want = want.rename(index=labels)
        assert list(table) == list(want.index)
        for label, stats in table.items():
            for stat, value in stats.items():
                expected = float(want.loc[label, stat])
                if math.isnan(expected):
                    assert math.isnan(value), (metric, label, stat)
                else:
                    assert value == pytest.approx(expected, rel=1e-12, abs=0), (metric, label, stat)
    combined = report.print_summary(rows)
    means = df.groupby("version")[["wpd", "rgc", "ipe"]].mean().rename(index=labels).round(4)
    for label, values in combined.items():
        for metric, value in values.items():
            expected = means.loc[label, metric]
            assert (math.isnan(value) and math.isnan(expected)) or value == expected
    assert report.print_summary([]) is None


def test_cli_writes_the_jax_csv(evaluated, tmp_path):
    """Both CLIs on copies of the corpus whose wp.json caches both runners
    wrote: the same CSV text."""
    _, _, tmp = evaluated
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_evaluate.main(["--config", str(_eval_settings(tmp, "jax", tmp / "jax" / "corpus")),
                              "--output-csv", str(jax_csv)]) == 0
    settings = _eval_settings(tmp, "port", tmp / "port" / "corpus")
    assert evaluate.main(["--config", str(settings), "--output-csv", str(port_csv),
                          "--device", "cpu"]) == 0
    assert port_csv.read_text() == jax_csv.read_text()
    # --metrics and --versions narrow the rows; the default path is the
    # settings' eval_output_dir.
    assert evaluate.main(["--config", str(settings), "--metrics", "rgc", "--versions", "human",
                          "--no-report", "--device", "cpu"]) == 0
    text = (tmp / "port" / "out" / "evaluation_results.csv").read_text().splitlines()
    assert text[0] == "song,version,rgc" and len(text) == 3


def test_cli_exit_codes(tmp_path, monkeypatch):
    empty = tmp_path / "corpus"
    empty.mkdir()
    (empty / "metadata.json").write_text("[]")
    settings = _eval_settings(tmp_path, "port", empty)
    assert evaluate.main(["--config", str(settings), "--device", "cpu"]) == 1
    missing = _eval_settings(tmp_path, "missing", tmp_path / "nowhere")
    assert evaluate.main(["--config", str(missing), "--device", "cpu"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--config", str(settings)])
