"""Audio download: `python -m etude_tpu_torch.utils.download URL --output
audio.wav`.

The port's own copy of etude_tpu/utils/download.py (reference surface:
etude/utils/download.py — yt-dlp → ffmpeg → wav), kept so that
etude_tpu_torch imports nothing of the JAX package. It shells out to
`yt-dlp` found on `PATH`, which needs `ffmpeg` to write WAV and the network
to fetch; where `yt-dlp` is missing it logs an error and returns False, so
a caller can stop with a clear message instead of crashing mid-pipeline.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import Union

from .logger import logger


def download_audio_from_url(url: str, output_path: Union[str, Path]) -> bool:
    """Download best audio from a URL and convert to WAV. Returns success."""
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)

    yt_dlp = shutil.which("yt-dlp")
    if yt_dlp is None:
        logger.error(
            "yt-dlp is not available in this environment; "
            "provide a local audio file instead of a URL"
        )
        return False

    cmd = [
        yt_dlp, "-f", "bestaudio",
        "--extract-audio", "--audio-format", "wav",
        "-o", str(output_path.with_suffix("")) + ".%(ext)s",
        url,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as exc:
        logger.error(f"download failed: {exc.stderr.strip()[:500]}")
        return False
    return output_path.exists()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Download audio from a URL")
    parser.add_argument("url")
    parser.add_argument("--output", default="audio.wav")
    args = parser.parse_args(argv)
    ok = download_audio_from_url(args.url, args.output)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
