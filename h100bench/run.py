"""Run one benchmark cell of the port on the card:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout; prints one JSON line of results last.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
