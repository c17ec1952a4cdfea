"""The port's download path (etude_tpu_torch/utils/download.py, `infer`'s URL
input, `prepare`'s stage 1) against the JAX package's
(etude_tpu/utils/download.py, the root infer.py and prepare.py), on the
CPU, with chip_smoke.py's stand-in for yt-dlp alone on PATH: it fetches
nothing, it copies the local file that its sources name for each URL (or
writes nothing, or fails with a line on stderr and exit 1).

Held equal: the yt-dlp argv (paths mapped from one package's output dir to
the other's), return values, exits, logged errors and warnings, the raw/
tree and the stub's call log of stage 1; the URL run's origin.wav and MIDI
against a file run's at the same seed. Where pandas's type inference
changes an id (a column of digits, an empty cell), the port keeps the text
as written; the two are shown side by side.
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import prepare as jax_prepare  # noqa: E402  (the root CLI)
from etude_tpu.config import load_config as jax_load_config  # noqa: E402
from etude_tpu.utils import download as jax_download  # noqa: E402
from etude_tpu.utils.logger import logger as jax_logger  # noqa: E402
from etude_tpu_torch import infer, prepare  # noqa: E402
from etude_tpu_torch.config import load_config  # noqa: E402
from etude_tpu_torch.utils import download, model_loader  # noqa: E402
from etude_tpu_torch.utils.logger import logger  # noqa: E402
from infer import InferencePipeline as JaxInferencePipeline  # noqa: E402
from infer import main as jax_infer_main  # noqa: E402
from test_torch_amt import committed_params  # noqa: E402,F401  (fixture)
from test_torch_pipeline import _settings, _song  # noqa: E402
from test_torch_structuralize import _committed  # noqa: E402

URL = "https://example.invalid/song"


@pytest.fixture
def logs(monkeypatch):
    """Each package's logger writing into a buffer of its own."""
    buffers = {"port": io.StringIO(), "jax": io.StringIO()}
    monkeypatch.setattr(logger, "stream", buffers["port"])
    monkeypatch.setattr(jax_logger, "stream", buffers["jax"])
    for each in (logger, jax_logger):   # the stage headers' numbers
        monkeypatch.setattr(each, "_stage_count", 0)
    return buffers


def _stub(tmp_path, monkeypatch, sources):
    """chip_smoke.py's yt-dlp stand-in alone on PATH; returns its call log."""
    log = chip_smoke.ytdlp_stub(tmp_path / "bin", sources)
    monkeypatch.setenv("PATH", str(log.parent))
    return log


def _calls(log):
    """The stub's calls so far, and the log emptied."""
    calls = chip_smoke.stub_calls(log)
    log.unlink(missing_ok=True)
    return calls


def _mapped(calls, frm, to):
    return [[a.replace(str(frm), str(to)) for a in argv] for argv in calls]


def _tree(root: Path) -> dict:
    """Every path under `root`, each file with its bytes."""
    return {str(p.relative_to(root)): p.read_bytes() if p.is_file() else None
            for p in sorted(root.rglob("*"))}


# ---- download_audio_from_url ----------------------------------------------

def test_without_yt_dlp_both_return_false_and_run_nothing(tmp_path, monkeypatch, logs):
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))

    def no_subprocess(*args, **kwargs):
        raise AssertionError("no command may run without yt-dlp")

    monkeypatch.setattr(subprocess, "run", no_subprocess)
    assert download.download_audio_from_url(URL, tmp_path / "port" / "a.wav") is False
    assert jax_download.download_audio_from_url(URL, tmp_path / "jax" / "a.wav") is False
    assert logs["port"].getvalue() == logs["jax"].getvalue()
    assert "yt-dlp is not available" in logs["port"].getvalue()
    assert (tmp_path / "port").is_dir() and not (tmp_path / "port" / "a.wav").exists()


def test_a_failing_download_logs_500_characters_of_stderr(tmp_path, monkeypatch, logs):
    log = _stub(tmp_path, monkeypatch, {})
    url = URL + "/" + "x" * 600   # the stub's stderr names the URL: over 500 characters
    assert download.download_audio_from_url(url, tmp_path / "port" / "a.wav") is False
    port_calls = _calls(log)
    assert jax_download.download_audio_from_url(url, tmp_path / "jax" / "a.wav") is False
    assert _mapped(port_calls, tmp_path / "port", tmp_path / "jax") == _calls(log)
    logged = logs["port"].getvalue()
    assert logged == logs["jax"].getvalue()
    assert logged == "✘ download failed: " + (
        f"ERROR: [generic] Unable to download {url}: no such source")[:500] + "\n"


def test_a_download_writes_the_file_with_the_jax_argv(tmp_path, monkeypatch, logs):
    source = tmp_path / "source.wav"
    source.write_bytes(b"RIFF-audio")
    log = _stub(tmp_path, monkeypatch, {URL: source})
    assert download.download_audio_from_url(URL, tmp_path / "port" / "deep" / "a.wav") is True
    port_calls = _calls(log)
    assert jax_download.download_audio_from_url(URL, tmp_path / "jax" / "deep" / "a.wav") is True
    jax_calls = _calls(log)
    assert _mapped(port_calls, tmp_path / "port", tmp_path / "jax") == jax_calls
    # chip_smoke.py holds the card's runs to this argv.
    assert jax_calls == [chip_smoke.ytdlp_argv(log.parent / "yt-dlp",
                                               tmp_path / "jax" / "deep" / "a.wav", URL)]
    assert (tmp_path / "port" / "deep" / "a.wav").read_bytes() == source.read_bytes()
    assert (tmp_path / "jax" / "deep" / "a.wav").read_bytes() == source.read_bytes()
    assert logs["port"].getvalue() == logs["jax"].getvalue() == ""


def test_a_download_that_writes_nothing_is_a_failure(tmp_path, monkeypatch, logs):
    _stub(tmp_path, monkeypatch, {URL: None})
    assert download.download_audio_from_url(URL, tmp_path / "port" / "a.wav") is False
    assert jax_download.download_audio_from_url(URL, tmp_path / "jax" / "a.wav") is False
    assert logs["port"].getvalue() == logs["jax"].getvalue() == ""


@pytest.mark.parametrize("known", [True, False], ids=["fetched", "failed"])
def test_the_cli_exits_as_jax_does(tmp_path, monkeypatch, logs, known):
    source = tmp_path / "source.wav"
    source.write_bytes(b"RIFF-audio")
    _stub(tmp_path, monkeypatch, {URL: source} if known else {})
    got = download.main([URL, "--output", str(tmp_path / "port.wav")])
    monkeypatch.setattr(sys, "argv", ["download.py", URL, "--output", str(tmp_path / "jax.wav")])
    assert got == jax_download.main() == (0 if known else 1)
    assert (tmp_path / "port.wav").exists() == (tmp_path / "jax.wav").exists() == known


# ---- infer --input URL ----------------------------------------------------

def test_url_input_fetches_origin_wav_as_jax_does(tmp_path, monkeypatch, logs):
    wav = _song(tmp_path / "song.wav", seconds=1.0)
    log = _stub(tmp_path, monkeypatch, {URL: wav})
    port = infer.InferencePipeline(load_config(_settings(tmp_path, "port")), device="cpu",
                                   allow_random_weights=True)
    jax = JaxInferencePipeline(jax_load_config(str(_settings(tmp_path, "jax"))),
                               allow_random_weights=True)
    assert port._prepare_audio(URL) == tmp_path / "port" / "temp" / "origin.wav"
    port_calls = _calls(log)
    assert Path(jax._prepare_audio(URL)) == tmp_path / "jax" / "temp" / "origin.wav"
    assert _mapped(port_calls, tmp_path / "port", tmp_path / "jax") == _calls(log)
    for side in ("port", "jax"):
        assert (tmp_path / side / "temp" / "origin.wav").read_bytes() == wav.read_bytes()


def test_url_input_without_yt_dlp_exits_1_in_both(tmp_path, monkeypatch, logs):
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for side, run in (("port", infer.main), ("jax", jax_infer_main)):
        with pytest.raises(SystemExit) as exit_:
            run(["--config", str(_settings(tmp_path, side)), "--input", URL, "--device", "cpu",
                 "--allow-random-weights"])
        assert exit_.value.code == 1
        assert not list((tmp_path / side).glob("*.mid"))
        assert "audio download failed" in logs[side].getvalue()


def test_url_input_serves_what_the_file_gives(tmp_path, monkeypatch, logs,
                                              committed_params):  # noqa: F811
    """test_torch_pipeline.py's settings (the committed extractor,
    separator and beat trees, a tiny random decoder): `--input URL` through
    the stub writes the file run's outputs and MIDI at the same seed."""
    trees = {"extractor": committed_params, "separator": _committed("separator"),
             "beat model": _committed("beat")}
    load = model_loader.load_params
    monkeypatch.setattr(model_loader, "load_params",
                        lambda what, *a, **kw: trees[what] if what in trees else load(what, *a, **kw))
    wav = _song(tmp_path / "song.wav")
    log = _stub(tmp_path, monkeypatch, {URL: wav})
    for side, source in (("file", str(wav)), ("url", URL)):
        assert infer.main(["--config", str(_settings(tmp_path, side)), "--input", source,
                           "--device", "cpu", "--allow-random-weights", "--seed", "3"]) == 0
    assert _calls(log) == [chip_smoke.ytdlp_argv(log.parent / "yt-dlp",
                                                 tmp_path / "url" / "temp" / "origin.wav", URL)]
    file_run, url_run = _tree(tmp_path / "file"), _tree(tmp_path / "url")
    assert file_run["temp/tempo.json"] != b"[]", "the song should give a grid"
    assert url_run["temp/origin.wav"] == wav.read_bytes()
    assert url_run == file_run
    assert "output.mid" in url_run


# ---- prepare, stage 1 -----------------------------------------------------

def _prepare_settings(tmp_path, side, csv_path):
    path = tmp_path / f"{side}.json"
    root = tmp_path / side
    path.write_text(json.dumps({"paths": {
        "dataset_csv": str(csv_path), "raw_dir": str(root / "raw"),
        "processed_dir": str(root / "processed"), "aligned_dir": str(root / "aligned"),
        "tokenized_dir": str(root / "tokenized"), "dataset_vocab": str(root / "vocab.json")}}))
    return path


def _stage_1(tmp_path, monkeypatch, csv_text, sources=None, existing=()):
    """Stage 1 of each package on `csv_text` with the stub on PATH (and the
    files `existing` in raw/ beforehand); returns {side: (call log, raw
    tree)}."""
    csv_path = tmp_path / "dataset.csv"
    csv_path.write_text(csv_text, encoding="utf-8")
    log = _stub(tmp_path, monkeypatch, sources or {})
    out = {}
    for side, load, run in (("port", load_config, prepare.run_stage_1_download),
                            ("jax", jax_load_config, jax_prepare.run_stage_1_download)):
        for name in existing:
            (tmp_path / side / "raw" / name).parent.mkdir(parents=True, exist_ok=True)
            (tmp_path / side / "raw" / name).write_bytes(b"already here")
        run(load(str(_prepare_settings(tmp_path, side, csv_path))))
        out[side] = (_calls(log), _tree(tmp_path / side / "raw"))
    return out


def test_stage_1_matches_jax(tmp_path, monkeypatch, logs):
    """A BOM, blank and whitespace-only lines (no position), quoted fields,
    an extra column, a target that exists (skipped) and an id the stub fails
    on (warned of, the rest fetched)."""
    sources = {}
    for i in ("c1", "o1", "o,2", "c3", "o3"):
        sources[prepare.YOUTUBE_URL + i] = tmp_path / f"{i}.wav"
        sources[prepare.YOUTUBE_URL + i].write_bytes(i.encode())
    csv_text = ("\ufefftitle,piano_ids,pop_ids\n"
                "one,c1,o1\n\n   \n"
                'two,unavailable,"o,2"\n\n'
                '"three, quoted",c3,o3\n')
    runs = _stage_1(tmp_path, monkeypatch, csv_text, sources, existing=["0003/cover.wav"])
    (port_calls, port_raw), (jax_calls, jax_raw) = runs["port"], runs["jax"]
    assert _mapped(port_calls, tmp_path / "port", tmp_path / "jax") == jax_calls
    assert [argv[-1].split("=")[-1] for argv in port_calls] == [
        "c1", "o1", "unavailable", "o,2", "o3"]
    assert port_raw == jax_raw == {
        "0001": None, "0001/cover.wav": b"c1", "0001/origin.wav": b"o1",
        "0002": None, "0002/origin.wav": b"o,2",
        "0003": None, "0003/cover.wav": b"already here", "0003/origin.wav": b"o3"}
    assert logs["port"].getvalue() == logs["jax"].getvalue()
    assert "⚠ 1 downloads failed: 0002" in logs["port"].getvalue()


@pytest.mark.parametrize("csv_text,error", [
    ("title,pop_ids\nt,o1\n", KeyError),                        # no piano_ids
    ("piano_ids,pop_ids\nc1,o1\nc2,o2,extra\n", ValueError),     # a row longer than the header
    ("", ValueError),                                            # no header
], ids=["missing-column", "long-row", "empty"])
def test_stage_1_fails_before_any_download_as_jax_does(tmp_path, monkeypatch, csv_text, error):
    csv_path = tmp_path / "dataset.csv"
    csv_path.write_text(csv_text)
    log = _stub(tmp_path, monkeypatch, {})
    for side, load, run in (("port", load_config, prepare.run_stage_1_download),
                            ("jax", jax_load_config, jax_prepare.run_stage_1_download)):
        with pytest.raises(error):
            run(load(str(_prepare_settings(tmp_path, side, csv_path))))
        assert _calls(log) == []


def test_a_missing_pop_ids_column_fails_before_any_download(tmp_path, monkeypatch):
    """(The JAX stage fetches the first cover before its KeyError.)"""
    csv_path = tmp_path / "dataset.csv"
    csv_path.write_text("piano_ids,title\nc1,t\n")
    log = _stub(tmp_path, monkeypatch, {})
    with pytest.raises(KeyError, match="pop_ids"):
        prepare.run_stage_1_download(load_config(_prepare_settings(tmp_path, "port", csv_path)))
    assert _calls(log) == []


@pytest.mark.parametrize("csv_text,jax_ids,port_ids", [
    # A column of digits: pandas reads int64, and the id loses its zeros.
    ("piano_ids,pop_ids\n007,0456\n", ["7", "456"], ["007", "0456"]),
    # An empty cell: pandas reads NaN, and a column of digits turns float.
    ("piano_ids,pop_ids\n123,abc\n,def\n", ["123.0", "abc", "nan", "def"],
     ["123", "abc", "", "def"]),
], ids=["digits", "empty-cell"])
def test_ids_keep_their_text_where_pandas_retypes_them(tmp_path, monkeypatch, logs,
                                                       csv_text, jax_ids, port_ids):
    """The port's deliberate departure from JAX's stage 1: the URL holds the
    id as written in the CSV, not as pandas's type inference reads it."""
    runs = _stage_1(tmp_path, monkeypatch, csv_text)
    ids = {side: [argv[-1][len(prepare.YOUTUBE_URL):] for argv in calls]
           for side, (calls, _) in runs.items()}
    assert ids == {"jax": jax_ids, "port": port_ids}


@pytest.mark.parametrize("csv_text", [
    "piano_ids,pop_ids\n\n\nc1,o1\n \t \nc2,o2\n",
    "\n\npiano_ids,pop_ids\nc1,o1\n",
    "\ufeffpiano_ids,pop_ids\r\nc1,o1\r\n\r\nc2,o2\r\n",
    'piano_ids,pop_ids\n"c,1","o""1"\n" c2 ",o2\n',
    "a,piano_ids,b,pop_ids,piano_ids\n1,c1,2,o1,dup\n",
    "piano_ids,pop_ids\n",
], ids=["blank-lines", "leading-blank", "bom-crlf", "quoted", "extra-columns", "header-only"])
def test_rows_read_as_pandas_reads_them(tmp_path, csv_text):
    import pandas as pd

    path = tmp_path / "dataset.csv"
    path.write_text(csv_text, encoding="utf-8", newline="")
    want = [{c: row[c] for c in ("piano_ids", "pop_ids")}
            for _, row in pd.read_csv(path).iterrows()]
    assert prepare.read_song_ids(path) == want


def test_no_csv_exits_1_in_both(tmp_path, logs):
    for side, main in (("port", prepare.main), ("jax", jax_prepare.main)):
        settings = _prepare_settings(tmp_path, side, tmp_path / "none.csv")
        argv = ["--config", str(settings), "--run-only", "download"]
        with pytest.raises(SystemExit) as exit_:
            main(argv + (["--device", "cpu"] if side == "port" else []))
        assert exit_.value.code == 1
        assert (tmp_path / side / "raw").is_dir()
    assert logs["port"].getvalue() == logs["jax"].getvalue()


def test_failed_downloads_go_on_to_stage_2_in_both(tmp_path, monkeypatch, logs):
    """The CLIs from their default `--start-from download`: every id fails,
    each warns and runs stages 2-5 (recorded here, not run)."""
    csv_path = tmp_path / "dataset.csv"
    csv_path.write_text("piano_ids,pop_ids\nc1,o1\nc2,o2\n")
    log = _stub(tmp_path, monkeypatch, {})
    ran = {"port": [], "jax": []}
    for stage, name in zip(prepare.STAGES[1:], ("run_stage_2_preprocess",
                                                "run_stage_3_align_and_filter",
                                                "run_stage_4_extract", "run_stage_5_tokenize")):
        monkeypatch.setitem(prepare.RUNNERS, stage,
                            lambda config, _s=stage, **_: ran["port"].append(_s))
        monkeypatch.setattr(jax_prepare, name, lambda config, _s=stage: ran["jax"].append(_s))
    port_settings = _prepare_settings(tmp_path, "port", csv_path)
    assert prepare.main(["--config", str(port_settings), "--allow-random-weights",
                         "--device", "cpu"]) == 0
    port_calls = _calls(log)
    assert jax_prepare.main(["--config", str(_prepare_settings(tmp_path, "jax", csv_path)),
                             "--allow-random-weights"]) == 0
    assert _mapped(port_calls, tmp_path / "port", tmp_path / "jax") == _calls(log)
    assert len(port_calls) == 4
    assert ran["port"] == ran["jax"] == list(prepare.STAGES[1:])
    assert _tree(tmp_path / "port" / "raw") == _tree(tmp_path / "jax" / "raw") == {
        "0001": None, "0002": None}
    for side in ("port", "jax"):
        assert "⚠ 2 downloads failed: 0001, 0002" in logs[side].getvalue()
