"""Training utilities: seeding and the port's checkpoint format (JAX
counterpart: etude_tpu/utils/training.py, which writes orbax).

The format, readable with numpy alone (and so on a machine without jax or
orbax):

- A params-only export (`save_params_only`, what serving loads) is a
  directory holding `params.npz`: the JAX package's parameter tree as numpy
  arrays, one entry per leaf under its `/`-joined path (`layers/qkv/w`; a
  list index is a path element of digits, `layers/3/q/w`). The decoder's
  export keeps f32 as trained; the auxiliary models' (`save_aux_params`)
  stores floats as f16, as the JAX package's `save_aux_params` does, with
  the training's `metadata.json` beside the directory. `load_params_only`
  promotes f16 to f32. The weight bridge (`weights.py`) reads the tree as
  it reads any JAX tree, so a later export of an orbax checkpoint into this
  format serves the same way. The directory's name carries no suffix: `.pt`,
  `.pth` and `.pkl` stay the reference's checkpoints.
- A training checkpoint (`save_checkpoint`) is a directory `latest` holding
  `params.npz` as above and `opt_state.npz`: the Adam moments as two more
  trees under `mu/` and `nu/`, the optimizer's update `count`, and `step`
  and `skipped` (int32 scalars). `latest` is replaced through
  `.latest.tmp` and `.latest.old`, so a kill mid-save never loses the last
  checkpoint; scheduled epochs are copied to `epoch_NNNN`. Beside them,
  `metadata.json` ({epoch, global_step, model_config}) and
  `etude_decoder_config.json`, with the JAX package's keys.

Under a process group (multi-GPU training), rank 0 alone writes, the full
tree whatever the layout (an FSDP state's shards are gathered first, which
every rank joins), and every rank waits at a barrier after the save; every
rank loads the same files onto its own layout. So a checkpoint of one rank
count resumes under another.
"""

from __future__ import annotations

import dataclasses
import json
import random
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .logger import logger
from ..models.decoder import EtudeDecoderConfig
from ..parallel.train_step import ShardedTrainState, all_gather, flat_views, full_params
from ..weights import ParamTree, decoder_state_from_jax, decoder_state_to_jax, rebuild_lists

PARAMS_FILE = "params.npz"
OPT_STATE_FILE = "opt_state.npz"


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def flatten_tree(tree: ParamTree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A tree of nested dicts and lists → {"/"-joined path: numpy array}; a
    list index is a path element of its decimal digits (`layers/3/q/w`)."""
    flat = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> ParamTree:
    """The inverse of `flatten_tree`: a node whose keys are all decimal
    digits becomes a list."""
    tree: ParamTree = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return rebuild_lists(tree)


def _load_npz(path: Path) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def is_params_dir(path: Union[str, Path]) -> bool:
    """True for a directory in the port's params-only format."""
    return (Path(path) / PARAMS_FILE).is_file()


def is_writer() -> bool:
    """True where files are written: the only process, or rank 0 of a
    process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (none: return)."""
    if dist.is_initialized():
        dist.barrier()


def full_moments(state: Any) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(mu, nu) under the parameters' names, whole: an FSDP state's shards
    are gathered (a collective)."""
    names = [name for name, _ in state.model.named_parameters()]
    if not isinstance(state, ShardedTrainState):
        return dict(zip(names, state.opt_state.mu)), dict(zip(names, state.opt_state.nu))
    out = []
    for shard in (state.opt_state.mu[0], state.opt_state.nu[0]):
        full = shard.new_empty(state.layout.padded)
        all_gather(full, shard, state.mesh)
        out.append(dict(zip(names, flat_views(full, state.layout))))
    return out[0], out[1]


def save_checkpoint(
    checkpoint_dir: Union[str, Path],
    state: Any,                      # parallel.train_step.TrainState or ShardedTrainState
    epoch: int,
    global_step: int,
    model_config: EtudeDecoderConfig,
    is_save_epoch: bool = False,
) -> Path:
    """Write `latest` (always) and an `epoch_NNNN` copy on save epochs.
    Reads the state back to the host (one synchronization). Under a
    process group every rank calls it: rank 0 writes, then all wait."""
    checkpoint_dir = Path(checkpoint_dir).resolve()
    latest = checkpoint_dir / "latest"
    params = full_params(state)
    mu, nu = full_moments(state)
    if is_writer():
        _write_checkpoint(checkpoint_dir, state, params, mu, nu, model_config)
    del params, mu, nu
    if is_writer():
        meta = {
            "epoch": epoch,
            "global_step": global_step,
            "model_config": dataclasses.asdict(model_config),
        }
        with open(checkpoint_dir / "metadata.json", "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=2)
        model_config.to_json_file(checkpoint_dir / "etude_decoder_config.json")
        if is_save_epoch:
            epoch_dir = checkpoint_dir / f"epoch_{epoch:04d}"
            if epoch_dir.exists():
                shutil.rmtree(epoch_dir)
            shutil.copytree(latest, epoch_dir)
            logger.debug(f"checkpoint copied to {epoch_dir}")
        logger.debug(f"checkpoint saved to {latest} (epoch {epoch}, step {global_step})")
    barrier()
    return latest


def _write_checkpoint(checkpoint_dir: Path, state: Any, params, mu, nu,
                      model_config: EtudeDecoderConfig) -> None:
    """`latest` from whole parameters and moments, each {name: tensor}."""
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    opt = state.opt_state
    opt_flat = {"count": opt.count.cpu().numpy(), "step": state.step.cpu().numpy(),
                "skipped": state.skipped.cpu().numpy()}
    for which, moments in (("mu", mu), ("nu", nu)):
        tree = decoder_state_to_jax(moments, model_config)
        opt_flat.update(flatten_tree(tree, f"{which}/"))

    latest = checkpoint_dir / "latest"
    # Crash-safe: write a scratch dir, then swap it in by renames.
    tmp = checkpoint_dir / ".latest.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    save_params_npz(tmp, decoder_state_to_jax(params, model_config))
    np.savez(tmp / OPT_STATE_FILE, **opt_flat)
    old = checkpoint_dir / ".latest.old"
    if old.exists():
        shutil.rmtree(old)
    if latest.exists():
        latest.rename(old)
    tmp.rename(latest)
    if old.exists():
        shutil.rmtree(old)


def _shard_of(named: Dict[str, torch.Tensor], names, state: ShardedTrainState) -> torch.Tensor:
    """This rank's shard of the flat vector holding the whole tensors `named`."""
    layout = state.layout
    full = torch.zeros(layout.padded, dtype=torch.float32, device=state.shard.device)
    torch._foreach_copy_(flat_views(full, layout),
                         [named[n].to(full.device) for n in names])
    return full[layout.lo:layout.hi]


@torch.no_grad()
def load_checkpoint(
    checkpoint_dir: Union[str, Path],
    state: Any,
    name: str = "latest",
) -> Tuple[Any, Dict[str, Any]]:
    """Restore a checkpoint into `state` (its tensors keep their devices and,
    for an FSDP state, its layout: each rank takes its shard) and return
    (state, metadata)."""
    checkpoint_dir = Path(checkpoint_dir).resolve()
    path = checkpoint_dir / name
    if not path.exists() and name == "latest" and is_writer():
        # Recover from a kill inside the save_checkpoint rename window.
        old = checkpoint_dir / ".latest.old"
        if old.exists():
            logger.warn("recovering checkpoint from interrupted save (.latest.old)")
            old.rename(path)
    barrier()
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")

    config = state.model.config
    params = decoder_state_from_jax(load_params_only(path), config)
    opt_flat = _load_npz(path / OPT_STATE_FILE)
    moments = unflatten_tree(
        {k: v for k, v in opt_flat.items() if k.startswith(("mu/", "nu/"))})
    names = [n for n, _ in state.model.named_parameters()]
    if isinstance(state, ShardedTrainState):
        state.shard.copy_(_shard_of(params, names, state))
        for which, shard in (("mu", state.opt_state.mu[0]), ("nu", state.opt_state.nu[0])):
            shard.copy_(_shard_of(decoder_state_from_jax(moments[which], config), names,
                                  state))
    else:
        for n, p in state.model.named_parameters():
            p.copy_(params[n])
        for which, targets in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
            restored = decoder_state_from_jax(moments[which], config)
            for n, t in zip(names, targets):
                t.copy_(restored[n])
    for key, target in (("count", state.opt_state.count), ("step", state.step),
                        ("skipped", state.skipped)):
        target.copy_(torch.from_numpy(opt_flat[key]))

    meta: Dict[str, Any] = {}
    meta_path = checkpoint_dir / "metadata.json"
    if meta_path.exists():
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
    logger.debug(f"checkpoint restored from {path}")
    return state, meta


def save_params_npz(path: Path, params: ParamTree) -> None:
    np.savez(path / PARAMS_FILE, **flatten_tree(params))


def save_params_only(path: Union[str, Path], params: ParamTree,
                     config: EtudeDecoderConfig) -> None:
    """Inference-weight export: the params tree in `path`/params.npz, the
    config beside `path` (as the JAX package's export lays them out)."""
    path = Path(path).resolve()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    save_params_npz(path, params)
    config.to_json_file(path.parent / "etude_decoder_config.json")


def save_aux_params(path: Union[str, Path], params: ParamTree,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Params-only export of an auxiliary model (extractor, beat model,
    separator; JAX `save_aux_params` :216): floats stored as f16, and
    `metadata` (the training's provenance) as `metadata.json` beside `path`."""
    path = Path(path).resolve()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    stored = {k: v.astype(np.float16) if np.issubdtype(v.dtype, np.floating) else v
              for k, v in flatten_tree(params).items()}
    np.savez(path / PARAMS_FILE, **stored)
    if metadata is not None:
        with open(path.parent / "metadata.json", "w", encoding="utf-8") as f:
            json.dump(metadata, f, indent=2)


def load_params_only(path: Union[str, Path]) -> ParamTree:
    """The params tree of a params-only export (or of a training
    checkpoint's directory), as numpy arrays; f16 leaves come back as f32
    (JAX `load_params_only` :195-200 promotes them likewise)."""
    path = Path(path)
    if not is_params_dir(path):
        raise FileNotFoundError(f"{path} holds no {PARAMS_FILE}")
    flat = _load_npz(path / PARAMS_FILE)
    return unflatten_tree({k: v.astype(np.float32) if v.dtype == np.float16 else v
                           for k, v in flat.items()})
