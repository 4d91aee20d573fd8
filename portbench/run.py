"""One run of one benchmark cell of the port ``pdc_tpu_torch``:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result's JSON object; the
compared numbers and their limits are the last lines of standard error.
Without a CUDA device it exits non-zero and prints no result. See
README.md.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "portbench", "torch_extensions"),
          "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "portbench", "triton")}


def main() -> int:
    os.environ.update(CACHES)
    sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.main(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
