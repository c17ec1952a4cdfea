"""Stall-detecting supervisor for long training runs (JAX counterpart:
scripts/supervise_train.py).

    python -m etude_tpu_torch.scripts.supervise_train --ckpt-dir outputs/train_distill/X \\
        [--stall-seconds 300] [--max-restarts 4] [--restart-on-crash] [--device cpu] -- \\
        python -m etude_tpu_torch.train --config ... --run-id X --save-every-steps 2000

Runs the command after `--` as a child in a session of its own and reads
its CPU time from `/proc/<pid>/stat` every `--poll-seconds`. A child that
burns under 1% of a CPU for `--stall-seconds` is taken as stalled: its whole
session is killed and the command restarted with `--resume <ckpt-dir>`
appended once `<ckpt-dir>/latest` exists (the training CLI then continues
from its last checkpoint; pair it with `--save-every-steps`). With
`--restart-on-crash` a non-zero exit restarts it too; after `--max-restarts`
restarts the supervisor gives up with 1. Otherwise it exits with the
child's code. `--device` is appended to the command unless it names one.

On a card the rule sees only the host: a child blocked in a CUDA
synchronize may spin (and look busy) or yield, depending on the context's
scheduling mode. `run(argv, on_poll=f)` calls `f(cpu_seconds, poll_seconds)`
at every poll, for measuring a child's CPU share.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Callable, Optional

from . import refuse_checkpoints

# Seconds between a stalled or crashed child and its restart.
SETTLE_SECONDS = 10.0


def cpu_seconds(pid: int) -> float:
    """User + system CPU seconds of `pid`, or -1 once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            parts = f.read().split()
        return (int(parts[13]) + int(parts[14])) / os.sysconf("SC_CLK_TCK")
    except (FileNotFoundError, ProcessLookupError):
        return -1.0


def run(argv=None, on_poll: Optional[Callable[[float, float], None]] = None) -> int:
    """The CLI's work; returns its exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print("usage: python -m etude_tpu_torch.scripts.supervise_train [opts] -- "
              "<train command ...>", file=sys.stderr)
        return 2
    split = argv.index("--")
    parser = argparse.ArgumentParser(description="Restart a stalled training run")
    parser.add_argument("--ckpt-dir", required=True,
                        help="run dir the command checkpoints into (appended as "
                             "--resume on restarts)")
    parser.add_argument("--stall-seconds", type=int, default=300)
    parser.add_argument("--poll-seconds", type=int, default=30)
    parser.add_argument("--max-restarts", type=int, default=4)
    parser.add_argument("--restart-on-crash", action="store_true",
                        help="also restart (with --resume) on nonzero child exits, "
                             "not just stalls")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="appended to the command as --device unless it has one")
    args = parser.parse_args(argv[:split])
    ckpt_dir = str(refuse_checkpoints(args.ckpt_dir, "--ckpt-dir"))
    cmd = argv[split + 1:]
    if "--device" not in cmd:
        cmd += ["--device", args.device]

    restarts = 0
    while True:
        run_cmd = list(cmd)
        if restarts and os.path.isdir(os.path.join(ckpt_dir, "latest")):
            run_cmd += ["--resume", ckpt_dir]
        print(f"[supervisor] launch (restart {restarts}): {' '.join(run_cmd)}", flush=True)
        # Own session: a stall kill must reach every grandchild (loader
        # threads' processes, shell wrappers), or one can keep the card.
        child = subprocess.Popen(run_cmd, start_new_session=True)
        last_cpu = cpu_seconds(child.pid)
        quiet = 0.0
        while True:
            try:
                code = child.wait(timeout=args.poll_seconds)
                break
            except subprocess.TimeoutExpired:
                pass
            now = cpu_seconds(child.pid)
            if now < 0:
                continue
            burn = now - last_cpu
            last_cpu = now
            if on_poll is not None:
                on_poll(burn, args.poll_seconds)
            if burn < 0.01 * args.poll_seconds:
                quiet += args.poll_seconds
            else:
                quiet = 0.0
            if quiet >= args.stall_seconds:
                print(f"[supervisor] STALL: <1% cpu for {quiet:.0f}s — killing child "
                      "process group", flush=True)
                try:
                    os.killpg(child.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    child.send_signal(signal.SIGKILL)
                child.wait()
                code = None
                break
        if code is not None:
            print(f"[supervisor] child exited {code}", flush=True)
            if code == 0 or not args.restart_on_crash:
                return code
        restarts += 1
        if restarts > args.max_restarts:
            print("[supervisor] restart budget exhausted", flush=True)
            return 1
        time.sleep(SETTLE_SECONDS)


def main(argv=None) -> int:
    return run(argv)


if __name__ == "__main__":
    sys.exit(main())
