"""The control of the correctness check: a run whose prover breaks the
guarantee the configuration states, soundness. In every witness of the
run's pool one private value is moved by one (the wire picked from the
seed among the first 1,000, each of which the instance uses), so the port
proves assignments that do not satisfy the instance. The plain
verifier has to reject those proofs, and the run has to come out not
correct. On a cell across several chips every rank proves the broken
pool. The benchmark's own runs never do this.

    python3 perfbench/control.py --workload keyless.hyrax --seeds 11,12,13 --seconds 1

prints one JSON line per seed: its checks and ``correct``.
"""

import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


class _Broken:
    """A witness pool whose witnesses have private value ``k`` moved by one."""

    def __init__(self, pool, k: int):
        self.pool, self.k = pool, k

    def __len__(self) -> int:
        return len(self.pool)

    def __getitem__(self, j: int):
        inputs, vals = self.pool[j]
        vals = list(vals)
        vals[self.k] = (vals[self.k] + 1) % FR
        return inputs, vals


def break_witness(seed: int):
    """A control hook for ``harness.run``: the pool, broken. It pickles, so
    that each rank of a cell on several chips breaks its own pool alike."""
    return functools.partial(_Broken, k=seed % 1000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          control=break_witness(seed))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "proofs": out["proofs"], "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
