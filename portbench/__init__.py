"""The benchmark of the PyTorch/CUDA port (`seeme_tpu_torch`), as
`BENCHMARK.json` at the repository's root describes it.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

runs one cell once on the card and prints its result line. Each
configuration (`configs/`), traffic mix (`traffic/`), reference
(`reference/<config>.py`), per-layer metric reader (`metrics/`), system
family (`systems/`), route through the program (`routes/`) and batch
generator (`generators/`) is a file found by its name. `tools/sets.py`
runs sets of runs of a cell for its spreads; `tools/calibrate.py` reads
the program's and the control's comparison gaps that the limits are set
from. The tests run on the CPU (`python -m pytest portbench/tests`); those
marked `gpu` run a short cell on the card.
"""
