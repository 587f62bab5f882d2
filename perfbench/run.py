"""Run one cell of the port's benchmark on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output (see ``perfbench.harness``), and
each number that decides ``correct`` beside its limit last on standard
error. Exits non-zero, printing no result, without the cards the cell asks
for or when JAX or the JAX package was loaded.
"""

import pathlib
import sys

_HERE = pathlib.Path(__file__).resolve().parent
# Run as a script, the folder itself would come first on the path and its
# modules would shadow others: import the package from the checkout instead.
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
