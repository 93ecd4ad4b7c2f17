"""The port's native loader against concurrent builders.

Tests run in several worker processes that each build the native library
on first use.  A process that loads the library while another one's
linker is still writing it gets no library, and keeps none for its whole
life, so every test of its files that needs it fails or skips.  The port's
loader (utils/native.py) links into a temporary file and renames it into
place, so the library's own name appears only once it is complete: a
process that loads it the moment it appears must succeed.
"""
import importlib.util
import multiprocessing as mp
import pathlib
import time

import spaced_kmer_sketching_tpu_torch.utils.native as port_native

NATIVE = pathlib.Path(port_native.__file__)


def _module(build_dir: str):
    """A fresh copy of the port's loader that builds into build_dir."""
    spec = importlib.util.spec_from_file_location("native_copy", NATIVE)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    m.BUILD_DIR = pathlib.Path(build_dir)
    return m


def _build(build_dir, q):
    q.put(("builder", _module(build_dir).get_lib() is not None))


def _load_on_sight(build_dir, q):
    m = _module(build_dir)
    so = m._so_path()
    deadline = time.monotonic() + 120
    while not so.exists() and time.monotonic() < deadline:
        time.sleep(0.0005)
    q.put(("loader", m.get_lib() is not None))


def test_a_library_loaded_the_moment_it_appears_is_whole(tmp_path):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_load_on_sight, args=(str(tmp_path), q)),
             ctx.Process(target=_build, args=(str(tmp_path), q))]
    for p in procs:
        p.start()
    for p in procs:
        p.join(180)
    assert sorted(q.get(timeout=5) for _ in procs) == [("builder", True),
                                                       ("loader", True)]
