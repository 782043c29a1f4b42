"""A child rank of drivers/train_dp.py with a training fault of
tools/readings.py planted first, named by the environment's
BENCH_PLANT_FAULT: the readings and the tests start the children through
this module (train_dp.CHILD_MODULE) to plant a fault on every rank.

    python3 -m benchmark.tools.plant_child SPEC
"""
from __future__ import annotations

import json
import os
import sys

from benchmark.drivers import train_dp
from benchmark.tools import readings


def main() -> int:
    spec = json.loads(sys.argv[1])
    owner, attr, value = readings.train_fault_table(
        spec["traffic"]["check_steps"])[os.environ[readings.PLANT_ENV]]
    setattr(owner, attr, value)
    return train_dp.main(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
