#!/usr/bin/env python3
"""Carry the committed model weights into the PyTorch port's format.

    JAX_PLATFORMS=cpu python export_weights.py [--out checkpoints_torch]

The four shipped checkpoints, `checkpoints/{decoder,separator,beat_detector,
extractor}/latest.ckpt`, are orbax trees that only orbax (with jax and
tensorstore) can read; the port runs where neither is installed. This script
reads each tree as the JAX package's loader does (an orbax restore,
etude_tpu/utils/training.py `load_params_only`, here without the promotion
and the device put, so the stored f16 values come back as they are) and
writes it once, params only, into `<out>/<model>/params.npz`: `/`-joined
leaf paths, floats in f16, as `etude_tpu_torch.utils.training.
save_aux_params` writes an export and `load_params_only` reads it (f16
promoted to f32, as the JAX loader does). `<out>/manifest.json` records, per
model, the source directory, the leaf and parameter counts, and the sha256
and size of its `params.npz`.

The port's default model paths (`etude_tpu_torch.config.PathConfig`) are
these exports. The decoder's config and vocabulary stay in
`checkpoints/decoder/`, where the port reads them. Nothing is written under
`checkpoints/`. A run that finds an export equal to its tree, leaf for leaf
and bit for bit, leaves the file alone; re-run the script after retraining
a checkpoint.

It needs jax and orbax, so it lies outside the port's package; nothing in
`etude_tpu_torch` imports it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path
from typing import Dict

import numpy as np

REPO = Path(__file__).resolve().parent
MODELS = ("decoder", "separator", "beat_detector", "extractor")
DEFAULT_OUT = REPO / "checkpoints_torch"
MANIFEST = "manifest.json"


def orbax_tree(model: str, checkpoints: Path = REPO / "checkpoints") -> Dict[str, np.ndarray]:
    """The committed params tree of `model`, flattened to {path: array} as
    stored (f16), read through the JAX package's checkpointer."""
    from etude_tpu.utils.training import _checkpointer
    from etude_tpu_torch.utils.training import flatten_tree

    restored = _checkpointer().restore((checkpoints / model / "latest.ckpt").resolve())
    if set(restored) != {"params"}:
        raise ValueError(f"{model}: expected a params-only checkpoint, got {sorted(restored)}")
    return {k: np.asarray(v) for k, v in flatten_tree(restored["params"]).items()}


def stored_tree(path: Path) -> Dict[str, np.ndarray]:
    """An export's arrays as stored (no promotion); {} when there is none."""
    if not path.is_file():
        return {}
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def same_tree(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def export(out: Path = DEFAULT_OUT, models=MODELS) -> dict:
    """Write every model's export that is missing or differs from its tree,
    and the manifest; returns the manifest."""
    from etude_tpu_torch.utils.training import PARAMS_FILE, save_aux_params, unflatten_tree

    out = out.resolve()
    if out.is_relative_to((REPO / "checkpoints").resolve()):
        raise ValueError(f"{out} is under checkpoints/, which holds the JAX package's files")
    manifest = {"format": "params.npz: '/'-joined leaf paths, floats stored as f16",
                "models": {}}
    for model in models:
        tree = orbax_tree(model)
        floats = {v.dtype for v in tree.values() if np.issubdtype(v.dtype, np.floating)}
        if floats - {np.dtype(np.float16)}:
            raise ValueError(f"{model}: leaves of {sorted(map(str, floats))}; the "
                             "export stores f16 and would round them")
        target = out / model / PARAMS_FILE
        if same_tree(stored_tree(target), tree):
            print(f"{model}: {target.relative_to(REPO)} is up to date")
        else:
            save_aux_params(out / model, unflatten_tree(tree))
            print(f"{model}: wrote {target.relative_to(REPO)}")
        manifest["models"][model] = {
            "source": f"checkpoints/{model}/latest.ckpt",
            "leaves": len(tree),
            "parameters": int(sum(v.size for v in tree.values())),
            "sha256": sha256(target),
            "bytes": target.stat().st_size,
        }
    text = json.dumps(manifest, indent=1) + "\n"
    path = out / MANIFEST
    if not path.is_file() or path.read_text() != text:
        path.write_text(text)
        print(f"wrote {path.relative_to(REPO)}")
    return manifest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT,
                        help="directory of the exports (default: checkpoints_torch)")
    args = parser.parse_args(argv)
    manifest = export(args.out)
    total = sum(m["bytes"] for m in manifest["models"].values())
    print(f"{len(manifest['models'])} models, {total} bytes of params.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
