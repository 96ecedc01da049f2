"""Loading a native library of ``native/`` read-only.

The port never rebuilds ``native/`` in place (the JAX package's loaders run
``make -C native``, which writes there). ``load_stamped`` loads the
committed binary when the stamp beside it (``<lib>.so.src.sha256``) is the
sha256 of its source, and otherwise compiles the source with
``g++ -O2 -fPIC -shared`` into the port's ``_build/``, keyed by the
source's hash.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

GXX_FLAGS = ("-O2", "-fPIC", "-shared")


@dataclasses.dataclass(frozen=True)
class NativeLibrary:
    lib: ctypes.CDLL
    path: Path
    built: bool  # compiled into _build/ (the committed binary's stamp did not match)
    digest: str  # sha256 of the source


def source_sha256(source: Path) -> str:
    return hashlib.sha256(source.read_bytes()).hexdigest()


def _committed_matches(committed: Path, digest: str) -> bool:
    stamp = committed.with_name(committed.name + ".src.sha256")
    return committed.is_file() and stamp.is_file() and stamp.read_text().split()[:1] == [digest]


def _build(source: Path, committed: Path, build_dir: Path, digest: str) -> Path:
    """Compile ``source`` into ``build_dir/<lib>_<sha>.so`` (atomic)."""
    so = build_dir / f"{committed.stem}_{digest[:16]}.so"
    if so.is_file():
        return so
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    if gxx is None:
        raise OSError("g++ not found")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(source), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed ({proc.returncode}): {proc.stderr}")
    os.replace(tmp, so)
    return so


def load_stamped(source: Path, committed: Path, build_dir: Path,
                 declare: Callable[[ctypes.CDLL], ctypes.CDLL]) -> NativeLibrary:
    """The committed library when its stamp matches ``source``, else a
    build of ``source``; ``declare`` sets the signatures. Raises OSError
    when neither loads."""
    digest = source_sha256(source)
    if _committed_matches(committed, digest):
        try:
            return NativeLibrary(declare(ctypes.CDLL(str(committed))), committed, False, digest)
        except OSError:
            pass  # e.g. another C library: build the source instead
    so = _build(source, committed, build_dir, digest)
    return NativeLibrary(declare(ctypes.CDLL(str(so))), so, True, digest)
