"""Run one cell of the port's benchmark once and print one JSON result line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name from `BENCHMARK.json`; see
`h100_bench/harness.py` for what a run does.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parent.parent

# Every cache the program or its libraries keep goes to a fixed directory
# inside the checkout, so that only the first run of a checkout builds.
# (The nvcc builds of `etude_tpu_torch/ops/_build.py` live in build/kernels.)
_CACHES = {
    "TRITON_CACHE_DIR": ROOT / "build" / "triton",
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "CUDA_CACHE_PATH": ROOT / "build" / "cuda_compute_cache",
}
for _key, _path in _CACHES.items():
    os.environ[_key] = str(_path)
os.environ["USE_FLAX"] = "0"     # no library the port uses may load JAX

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
