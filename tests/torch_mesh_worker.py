"""One rank of a gloo world that runs the port's training step over a mesh
(etude_tpu_torch/parallel/), for the multi-rank tests; and `launch`, which
runs such worlds as subprocesses under a deadline.

    python tests/torch_mesh_worker.py spec.json RANK

It imports torch and the port only (no JAX, no conftest), so a rank starts
in a few seconds. The spec (JSON) names the world size, the file store, the
batches (an .npz of [B, T] host batches under `b<i>/<key>`), the mode
("dp": replicated parameters; "fsdp"; "mean": replicated, with each rank's
loss divided by its own label count times the world size, the average of
per-rank means that DistributedDataParallel computes), the optimizer, the
steps after which rank 0 saves whole parameters and moments (`snap<k>.npz`),
a step at which the last rank's activations turn NaN (`nan_step`), a
checkpoint to load first (rank 0 saves what it restored as `loaded.npz`) or
to save after a step, and whether to check that checkpoint's bitwise
resume. Each rank writes its metrics to
`rank<r>.json` in the spec's `out` directory. `spawn_probe` is a rank for
`parallel.mesh.spawn_ranks`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TIMEOUT_S = 60.0   # the process group's own limit on a stalled collective


def _batches(path: str) -> List[Dict[str, np.ndarray]]:
    with np.load(path) as f:
        n = len({k.split("/")[0] for k in f.files})
        return [{k.split("/", 1)[1]: f[k] for k in f.files if k.startswith(f"b{i}/")}
                for i in range(n)]


def main(spec_path: str, rank: int) -> None:
    import datetime

    import torch.distributed as dist
    from etude_tpu_torch.models.decoder import EtudeDecoderConfig
    from etude_tpu_torch.parallel.mesh import initialize_multihost, make_mesh, shard_batch
    from etude_tpu_torch.parallel.train_step import (
        full_params, init_sharded_state, make_optimizer, make_train_step, reshape_for_accum,
    )
    from etude_tpu_torch.utils.training import (
        flatten_tree, full_moments, load_checkpoint, save_checkpoint,
    )
    from etude_tpu_torch.weights import decoder_from_jax, decoder_state_to_jax, init_decoder_params_np

    spec = json.loads(Path(spec_path).read_text())
    torch.set_num_threads(1)
    world, out = spec["world"], Path(spec["out"])
    initialize_multihost(f"file://{spec['store']}", world, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
    mesh = make_mesh(data_parallel=world)
    config = EtudeDecoderConfig(**spec["config"])
    tx, _ = make_optimizer(**spec["opt"])
    step_fn = make_train_step(config, tx, compute_dtype=torch.float32, mesh=mesh)
    fsdp = spec["mode"] == "fsdp"

    def fresh(seed):
        model = decoder_from_jax(init_decoder_params_np(config, seed), config)
        return init_sharded_state(model, tx, mesh, fsdp=fsdp)

    def device_batch(host):
        local = shard_batch(reshape_for_accum(host, spec["accum"]), mesh)
        if spec["mode"] == "mean":
            counts = (local["labels"] != -100).reshape(spec["accum"], -1).sum(axis=1)
            local["n_labels"] = np.maximum(counts, 1) * world
        return {k: torch.from_numpy(v) for k, v in local.items()}

    def whole(state):
        """Parameters and moments as one flat {path: array} of JAX trees."""
        mu, nu = full_moments(state)
        flat = {}
        for name, tensors in (("params", full_params(state)), ("mu", mu), ("nu", nu)):
            flat.update(flatten_tree(decoder_state_to_jax(tensors, config), f"{name}/"))
        return flat

    state = fresh(0)
    if spec.get("load"):
        load_checkpoint(spec["load"], state)
        flat = whole(state)
        if rank == 0:
            np.savez(out / "loaded.npz", **flat)
    record: Dict = {"metrics": [], "kept": None}
    if fsdp:
        record["resident"] = {
            "shard": state.shard.numel(), "mu": state.opt_state.mu[0].numel(),
            "nu": state.opt_state.nu[0].numel(),
            "model_bytes": sum(p.untyped_storage().nbytes() for p in state.params()),
            "params": sum(p.numel() for p in state.params())}
    batches = _batches(spec["batches"])
    for i, host in enumerate(batches):
        hook = None
        if i == spec.get("nan_step", -1):
            before = whole(state)
            if rank == world - 1:   # this rank's rows alone turn non-finite
                hook = state.model.attr_proj.register_forward_hook(
                    lambda module, args, output: output + float("nan"))
        metrics = step_fn(state, device_batch(host))
        record["metrics"].append({k: float(v) for k, v in metrics.items()})
        if hook is not None:
            hook.remove()
        if i == spec.get("nan_step", -1):
            after = whole(state)
            record["kept"] = all(np.array_equal(before[k], after[k]) for k in before)
        if i in spec.get("snap", []):
            flat = whole(state)
            if rank == 0:
                np.savez(out / f"snap{i}.npz", **flat)
        if i == spec.get("save_after", -1):
            save_checkpoint(spec["ckpt"], state, epoch=0, global_step=int(state.step),
                            model_config=config)
            if spec.get("resume_check"):
                # The checkpoint onto a state from other weights: a step
                # from each on the next batch must give the same bits.
                restored, _ = load_checkpoint(spec["ckpt"], fresh(1))
                nxt = device_batch(batches[i + 1])
                direct = step_fn(state, nxt)
                resumed = step_fn(restored, nxt)
                record["resume"] = {
                    "direct": float(direct["loss"]), "resumed": float(resumed["loss"]),
                    "same_state": all(np.array_equal(a, b) for a, b in
                                      zip(whole(state).values(), whole(restored).values()))}
                break
    record.update(step=int(state.step), skipped=int(state.skipped),
                  count=int(state.opt_state.count))
    (out / f"rank{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def spawn_probe(rank: int, world: int, address: str, out: str, fail_rank: int) -> None:
    """A rank for `parallel.mesh.spawn_ranks`: rank `fail_rank` raises
    before it joins; the others sum their ranks over gloo, and rank 0
    writes {"world", "sum"} to `out`."""
    import datetime

    import torch.distributed as dist
    from etude_tpu_torch.parallel.mesh import initialize_multihost

    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    initialize_multihost(address, world, rank, device="cpu",
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
    total = torch.tensor([rank])
    dist.all_reduce(total)
    if rank == 0:
        Path(out).write_text(json.dumps({"world": world, "sum": int(total)}))
    dist.destroy_process_group()


def launch(specs: List[Dict], tmp: Path, deadline_s: float = 120.0) -> List[Path]:
    """Run every spec's world at once, one subprocess per rank; kill them
    all past the deadline. Returns each spec's output directory; raises
    with the ranks' logs if any rank failed."""
    procs = []
    outs = []
    for n, spec in enumerate(specs):
        run = tmp / f"world{n}"
        (run / "out").mkdir(parents=True)
        spec = {**spec, "store": str(run / "store"), "out": str(run / "out")}
        (run / "spec.json").write_text(json.dumps(spec))
        outs.append(run / "out")
        for rank in range(spec["world"]):
            log = open(run / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, __file__, str(run / "spec.json"), str(rank)],
                stdout=log, stderr=subprocess.STDOUT), log, run / f"rank{rank}.log"))
    end = time.monotonic() + deadline_s
    failed = []
    for proc, log, path in procs:
        try:
            rc = proc.wait(timeout=max(end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            rc = "killed at the deadline"
        log.close()
        if rc != 0:
            failed.append(f"{path} ({rc}):\n{path.read_text()[-3000:]}")
    for proc, _, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
