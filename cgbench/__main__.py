"""``python3 -m cgbench``: run one cell once (see :mod:`cgbench.launch`
and :mod:`cgbench.harness`)."""

import time

# set-up is timed from here, before torch is imported
T0 = time.perf_counter()

if __name__ == "__main__":
    import sys

    from cgbench.launch import main

    sys.exit(main(T0))
