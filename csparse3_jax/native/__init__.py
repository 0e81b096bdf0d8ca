"""Native host libraries, built from ``native/`` on first use.

Nothing binary is shipped: ``ensure_built`` compiles a library with
``make -C native`` when it is missing or older than its sources, so each
host runs code compiled for its own CPU (the Makefile uses
``-march=native``).  Several processes may import the package at once
(pytest-xdist workers, a benchmark's children), so the build runs under an
exclusive file lock, writes to a private temporary name and is moved into
place with ``os.replace``: no process ever loads a half-written library.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "native")

# library file -> (Makefile variable naming its output, source files)
_LIBS = {
    "libhost_ext.so": ("TARGET", ("host_ext.cpp", "lu_sn.cpp",
                                  "host_common.h", "Makefile")),
    "_npalloc.so": ("NPALLOC", ("npalloc.c", "Makefile")),
}


def _stale(path: str, src: str, sources) -> bool:
    if not os.path.exists(path):
        return True
    built = os.path.getmtime(path)
    return any(os.path.getmtime(os.path.join(src, s)) > built
               for s in sources)


def ensure_built(name: str, timeout: float = 300.0, src_dir: str = _SRC,
                 out_dir: str = _DIR) -> str:
    """Return the path of native library ``name`` in ``out_dir``, building
    it from ``src_dir`` first when it is missing or stale.  Raises
    ImportError when the sources are absent or the build fails (callers
    fall back to numpy kernels)."""
    var, sources = _LIBS[name]
    path = os.path.join(out_dir, name)
    if not all(os.path.exists(os.path.join(src_dir, s)) for s in sources):
        if os.path.exists(path):
            return path  # installed without sources: use what is there
        raise ImportError(f"native sources not found under {src_dir}")
    if not _stale(path, src_dir, sources):
        return path
    with open(os.path.join(out_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale(path, src_dir, sources):  # another process built it
            return path
        tmp = os.path.join(out_dir, f".{name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["make", "-C", src_dir, f"{var}={tmp}", tmp],
                           check=True, capture_output=True, text=True,
                           timeout=timeout)
            os.replace(tmp, path)
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or ""
            raise ImportError(
                f"native build of {name} failed: {e} {detail[-400:]}") from e
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path
