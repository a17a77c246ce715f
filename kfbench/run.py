"""The benchmark of kinfu_tpu_torch: one run of one cell.

    python3 kfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (`kinfu_tpu_torch/`),
on a machine with the CUDA cards the cell asks for. With --trace 0 the
result's metrics are the cell's end-to-end metrics, with --trace 1 its
per-layer metrics (BENCHMARK.json). The last line of standard output is
the result, one JSON object; the numbers the check compared, each beside
its limit, are the last lines of standard error and the result's last
key. Without the cards, or if the run loaded a module of the JAX package
or JAX itself, it prints no result and exits with 2 or 3.

Every cache of the run lies inside the checkout: the port builds its
kernels into build/kernels/, and the trace goes to build/kfbench/.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from kfbench import harness

    entry = harness.load_cell(args.workload)
    chips = int(entry["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kfbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    import kinfu_tpu_torch  # noqa: F401  (full-float32 matmuls, as the port's users get)

    harness._log(f"card: {_power()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = harness.run(entry, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                      T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"kfbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for line in res.pop("log"):
        harness._log(line)
    for k, v in res["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
