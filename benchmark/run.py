"""Run one cell of the benchmark:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for.  Prints the checks on standard error and one JSON result line
last on standard output; exits non-zero, with no result, without the
devices or if the run loaded JAX or the JAX package.
"""
import time

T_PROCESS = time.perf_counter()

if __name__ == "__main__":
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from benchmark.harness import main
    sys.exit(main(sys.argv[1:], T_PROCESS))
