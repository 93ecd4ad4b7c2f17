"""Host allocator tuning for gVisor-style container runtimes.

A behaviour-identical copy of the JAX package's utils/hostmem.py (the port
imports nothing of that package).

First-touch page faults on freshly mmap'd memory cost ~100-500 us/page in
such environments (the JAX package measured a fresh 32 MB numpy temporary
taking ~2 s to touch, the same buffer re-used ~10 ms).  glibc's default
malloc serves every large numpy temporary from a fresh mmap and returns it
to the OS on free, so allocation-heavy host stages pay the full fault cost
on EVERY call.

`tune()` raises M_MMAP_THRESHOLD / M_TRIM_THRESHOLD via mallopt(3) so
large blocks come from the reusable heap instead: each buffer size-class
faults once per process and is then recycled.  No-op (returns False) on
platforms without glibc mallopt.
"""
from __future__ import annotations

_done = False


def tune(threshold: int = 1 << 30) -> bool:
    """Keep allocations below `threshold` bytes on the reusable heap."""
    global _done
    if _done:
        return True
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = libc.mallopt(-3, threshold)     # M_MMAP_THRESHOLD
        ok &= libc.mallopt(-1, threshold)    # M_TRIM_THRESHOLD
        _done = bool(ok)
        return _done
    except Exception:
        return False
