"""allpairs.sketch_kernels_ms: device ms a job of the sketch kernels,
summed by name from the profiler: K7 (extract, csrc/extract.cu), K2 and K3
(compaction, csrc/compact.cu) and K4 (csrc/sort.cu's register-tile sort
and its levels)."""
from benchmark import trace

KERNELS = ("slide_kernel", "compact_rows_kernel", "compact_count_kernel",
           "compact_offset_kernel", "compact_scatter_kernel",
           "reg_tile_sort_kernel", "sort_level_kernel")


def read(run):
    if run.trace is None or not run.records:
        return None
    s = trace.device_seconds(run.trace, KERNELS)
    return s / len(run.records) * 1e3 if s else None
