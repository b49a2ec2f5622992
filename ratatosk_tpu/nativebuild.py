"""Build-on-demand for the native host libraries (native/*.cpp).

native/build.sh compiles with -march=native, so a library is only valid on
the CPU it was built for. Each library therefore carries a stamp file
beside it (`<lib>.stamp`) holding a hash of its source, build.sh and the
host CPU's model and flags; the library is rebuilt whenever the stamp does
not match, whatever the files' modification times say.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")

# build.sh target -> (library, source)
LIBS = {
    "kmers": ("libkmers.so", "kmers.cpp"),
    "fastx": ("libfastx.so", "fastx.cpp"),
    "align": ("libralign.so", "align.cpp"),
}


def _cpu_id() -> str:
    """CPU model and feature flags: what -march=native compiles for."""
    keep = ("model name", "flags", "Features", "CPU part")
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln.strip() for ln in f
                     if ln.split(":")[0].strip() in keep]
        # the first processor's entries describe the host
        return "\n".join(dict.fromkeys(lines))
    except OSError:
        return platform.machine() + platform.processor()


def build_key(target: str, native_dir: str = NATIVE_DIR) -> str:
    h = hashlib.sha256()
    for name in (LIBS[target][1], "build.sh"):
        with open(os.path.join(native_dir, name), "rb") as f:
            h.update(f.read())
    h.update(_cpu_id().encode())
    return h.hexdigest()


def ensure_built(target: str, native_dir: str = NATIVE_DIR) -> str:
    """Path of the target's library, (re)built unless its stamp matches.

    Raises subprocess.CalledProcessError / OSError when the build fails;
    callers fall back to their NumPy paths."""
    lib = os.path.join(native_dir, LIBS[target][0])
    stamp = lib + ".stamp"
    key = build_key(target, native_dir)
    # one builder at a time: concurrent processes (test workers) would
    # otherwise rebuild the same library over each other
    with open(os.path.join(native_dir, ".build.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            with open(stamp) as f:
                fresh = f.read() == key and os.path.exists(lib)
        except OSError:
            fresh = False
        if not fresh:
            subprocess.run(["sh", os.path.join(native_dir, "build.sh"),
                            target], check=True, capture_output=True)
            with open(stamp, "w") as f:
                f.write(key)
    return lib


def build_all(native_dir: str = NATIVE_DIR) -> None:
    for target in LIBS:
        ensure_built(target, native_dir)
