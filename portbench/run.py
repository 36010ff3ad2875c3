"""Entry point of the port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Caches go under the checkout
(``portbench/.cache``, the kernels' build directory is the program's own
``hikari_tpu_torch/build/``), so only a checkout's first run builds."""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    cache = ROOT / "portbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))
    if sys.path[1:2] == [str(ROOT / "portbench")]:
        del sys.path[1]
    from portbench.harness import main

    sys.exit(main())
