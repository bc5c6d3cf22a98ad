"""Build-at-first-use for the port's two shared libraries.

Both libraries are compiled from sources in this repository into
``csparse3_tpu_torch/_build/`` (git-ignored): the host C++ kernels of
``native/`` with ``g++`` (``native/host_ext.py``) and the CUDA kernels of
``csrc/`` with ``nvcc`` (``kernels/bandpoints.py``).  The output name
carries a hash of the command line, of every source byte and of the
target the host compiler resolves ``-march=native`` to, so an edited
source or flag, or a build directory copied from another machine, never
loads a stale library.  An exclusive file lock makes
concurrent first uses (test workers, several processes on one host) build
once; the compiler writes to a temporary name that is renamed into place,
so a reader never sees a half-written library.

A failed build raises ``BuildError`` with the compiler's output: no caller
falls back to another implementation.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

__all__ = ["BUILD_DIR", "BuildError", "build_shared_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: directory the libraries are built into (listed in .gitignore)
BUILD_DIR = os.path.join(_PKG, "_build")
#: repository root: the ``native/`` C++ sources live there
REPO_ROOT = os.path.dirname(_PKG)


class BuildError(RuntimeError):
    """A compiler was missing or refused a source."""


def build_shared_library(name, sources, command, key="", timeout=600):
    """Return the path of ``lib<name>-<hash>.so``, building it if needed.

    ``command(out_path)`` returns the compiler argv that writes the
    library to ``out_path``; ``sources`` are hashed with it, and ``key``
    (what else the output depends on, such as the CPU that
    ``-march=native`` resolves to).
    """
    h = hashlib.sha256()
    h.update(repr(command("OUT")).encode())
    h.update(key.encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):  # built by another process meanwhile
                return path
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                proc = subprocess.run(command(tmp), capture_output=True,
                                      text=True, timeout=timeout)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise BuildError(f"building {name} failed: {e}") from e
            if proc.returncode != 0:
                raise BuildError(
                    f"building {name} failed (exit {proc.returncode}):\n"
                    f"{' '.join(command(tmp))}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
            return path
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
