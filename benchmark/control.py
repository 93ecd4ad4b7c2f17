"""Run a cell's control on the card, seed by seed, in one process:

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds 1,2,3

Each seed is a full run of the cell (set-up, a window of `--seconds`, the
check); then the operation's control, the reference put in the program's
place at a lower precision (or with one stated guarantee broken), is
compared with the reference in the same way.  Prints one JSON line a
seed: the program's checks and the control's.  The benchmark's own runs
never run it."""
import time

T_PROCESS = time.perf_counter()

if __name__ == "__main__":
    import argparse
    import json
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from benchmark import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    harness.fix_cache_dirs(harness.ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    for seed in (int(s) for s in args.seeds.split(",")):
        res, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                  t_process=time.perf_counter(), control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"],
                          "control": res["control"]}), flush=True)
