"""The readings that the limits of `limits/<workload>.json` are set from,
for one cell, in one process: for each seed a short run of the cell
(set-up, a window of `--seconds`, the check), which gives the system's
numbers, and the control's numbers on the same frames and states: the
reference put in the system's place and computed in bfloat16, the step
below the float32 that the configurations state, judged by the float32
reference as the system is.

    python3 kfbench/control.py --workload <name> --seeds 11,12,13 [--seconds 3] [--out F]

On the card only. Prints one JSON line a seed, then the largest system
reading and the smallest control reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", help="a file to which each seed's line is appended as well")
    args = ap.parse_args(argv)
    import torch

    from kfbench import harness

    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    import kinfu_tpu_torch  # noqa: F401

    entry = harness.load_cell(args.workload)
    sound, ctrl = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(entry, seed, args.seconds, False, torch.device("cuda"),
                          time.perf_counter(), control_dt=torch.bfloat16)
        for line in res["log"]:
            print(f"  {seed}: {line}", flush=True)
        nums = res["system"]
        line = json.dumps({"seed": seed, "correct": res["correct"], "failed": res["failed"],
                           "frame_ms": res["metrics"]["frame_ms"]["value"], "system": nums,
                           "control": res["control"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        for k, v in nums.items():
            sound[k] = max(sound.get(k, v), v)
        for k, v in res["control"].items():
            ctrl[k] = min(ctrl.get(k, v), v)
    print(json.dumps({"workload": args.workload, "system_max": sound, "control_min": ctrl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
