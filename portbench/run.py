"""The port's benchmark: ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.

Run from the root of a checkout.  It measures the PyTorch and CUDA port
(``src/repro_torch``) on the card; see ``portbench/harness.py``.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths (the port's
# kernels build into build/kernels/ there by themselves)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the port dispatches from one host thread, and idle pools only add jitter
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
