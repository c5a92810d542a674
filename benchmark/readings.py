"""The two readings that a cell's limits are set from, in one process on
one CUDA card:

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--seconds 3]

For each seed, a run of the cell with a short window: its numbers compared
with the plain reference (the program's reading, whose largest over a dozen
seeds is the lower one) and, for the control seeds, the same numbers with
the driver's control in the program's place (the reference in the
precision below the configuration's, or with one of its guarantees broken),
whose smallest is the upper one. One JSON line a seed. The benchmark's own
runs (run.py) never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.process import prepare  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    prepare()                                # before torch is imported
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("readings.py: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload)
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, device, t0,
                               control=seed in controls)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"],
                          "control": res.get("control"),
                          "metrics": res["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        harness.free_device(device)
    print(f"readings.py: {time.perf_counter() - T_START:.1f} s in all",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
