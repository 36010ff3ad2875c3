"""The control of the check that decides `correct`: on each seed, one run of
a cell (set-up and a window of --seconds) whose outputs are compared with
the reference as the benchmark compares them (the program's readings),
and then with the reference computed in bfloat16 put in the program's
place (the control's readings). Each line holds both; the limits in a
cell's file lie above the program's largest reading and below the
control's smallest. The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, device=None, root=None, overrides=None):
    import argparse

    import torch

    from portbench.harness import Run, load_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    info = load_cell(args.workload, root or ROOT)
    for key, patch in (overrides or {}).items():
        info[key].update(patch)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    out = []
    for seed in args.seeds:
        t0 = time.time()
        run = Run(info, seed, device)
        run.setup()
        run.window(args.seconds)
        run.release()
        prog, prog_detail = run.check()
        ctrl, ctrl_detail = run.check(control=True)
        line = {"workload": args.workload, "seed": seed, "units": run.units,
                "program": prog, "control": ctrl, "program_detail": prog_detail,
                "control_detail": ctrl_detail, "s": time.time() - t0}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    r = main()
    sys.exit(r if isinstance(r, int) else 0)
