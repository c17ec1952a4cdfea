"""Evaluation of rendered covers with WPD / RGC / IPE on one GPU:
`python -m etude_tpu_torch.evaluate [--device cpu] ...`.

The port of the repository's `evaluate.py`: for every song of
`eval.metadata_path` under `eval.eval_dir` and every version, WPD aligns
`<version>.wav` to `origin.wav` (on the card unless `--device cpu` is
given; a `wp.json` beside them, from either package, is read first), RGC
and IPE read `<version>.mid` or `<version>.json`. It writes the CSV of the
JAX CLI (`paths.eval_output_dir` / `eval.report_csv_filename` unless
`--output-csv`) and prints the summary tables; it exits 1 when there is no
result. With no `--config`, the settings are the defaults of
`etude_tpu_torch.config`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .config import load_config
from .evaluation.reporting import ReportGenerator
from .evaluation.runner import EvaluationRunner, write_csv
from .utils.logger import logger


def main(argv=None, timer=None) -> int:
    """The CLI; `timer` (a StageTimer) records a span per song, for callers
    that read them."""
    parser = argparse.ArgumentParser(description="Evaluate generated covers (PyTorch port)")
    parser.add_argument("--config", type=str, default=None,
                        help="settings file (.json, or YAML with PyYAML)")
    parser.add_argument("--metrics", nargs="+", default=["wpd", "rgc", "ipe"],
                        choices=["wpd", "rgc", "ipe"])
    parser.add_argument("--versions", nargs="+", default=None)
    parser.add_argument("--output-csv", type=str, default=None)
    parser.add_argument("--no-report", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    config = load_config(args.config)
    runner = EvaluationRunner(config, device=args.device)
    rows = runner.run(versions=args.versions, metrics=args.metrics, timer=timer)
    if not rows:
        logger.warn("evaluation produced no results")
        return 1

    csv_path = args.output_csv or (
        Path(config.paths.eval_output_dir) / config.eval.report_csv_filename
    )
    Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
    write_csv(rows, csv_path)
    logger.success(f"results written to {csv_path}")

    if not args.no_report:
        ReportGenerator(dict(config.eval.versions)).print_summary(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
