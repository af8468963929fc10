"""Build the native JPEG decoder shared library on demand.

Compiles meterelf_jpeg.c into ``_build/`` next to this file. The library's
name carries a key: the sha256 of the source, the compiler and linker
arguments, and the host CPU's model and feature flags. A library built by
another source, with other flags, or on another CPU (``-march=native``) is
never loaded; a fresh one is built instead.

libjpeg(-turbo) comes from the system when the linker finds it. A host
without one (no package, no headers) links the libjpeg-turbo that the
Pillow wheel bundles, with the vendored public headers in ``include/``;
the decoder self-check at load (io/jpeg.py) holds either library to the
pinned decode parity. No pip dependency: plain gcc.
"""
from __future__ import annotations

import ctypes.util
import glob
import hashlib
import importlib.util
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "meterelf_jpeg.c")
BUILD_DIR = os.path.join(_HERE, "_build")
VENDORED_INCLUDE = os.path.join(_HERE, "include")


def libjpeg_link_args() -> list:
    """Linker arguments naming the libjpeg to link: the system library
    when one is installed, else the copy inside the Pillow wheel (found
    without importing Pillow). Raises when neither exists."""
    name = ctypes.util.find_library("jpeg")
    if name:
        return [f"-l:{name}"]
    spec = importlib.util.find_spec("PIL")
    for loc in (spec.submodule_search_locations or []) if spec else []:
        libs = sorted(glob.glob(os.path.join(
            os.path.dirname(loc), "pillow.libs", "libjpeg*.so*")))
        if libs:
            return [libs[0], f"-Wl,-rpath,{os.path.dirname(libs[0])}"]
    raise RuntimeError(
        "no libjpeg found: install libjpeg-turbo (e.g. libjpeg62-turbo) "
        "to build the native JPEG decoder")


def _cpu_signature() -> str:
    """Model name and feature flags of the first CPU (what -march=native
    compiles for)."""
    keep = ("model name", "flags", "vendor_id", "cpu family", "model")
    lines = []
    try:
        with open("/proc/cpuinfo") as fp:
            for line in fp:
                if not line.strip():
                    break
                if line.split(":")[0].strip() in keep:
                    lines.append(line.strip())
    except OSError:
        pass
    return "\n".join(lines)


def build_key(args: list) -> str:
    """sha256 over the source, the build arguments and the CPU."""
    h = hashlib.sha256()
    with open(SRC, "rb") as fp:
        h.update(fp.read())
    h.update("\0".join(args).encode())
    h.update(_cpu_signature().encode())
    return h.hexdigest()[:20]


def _build_args() -> list:
    return (["gcc", "-O3", "-march=native", "-fPIC", "-shared", "-pthread",
             "-idirafter", VENDORED_INCLUDE, SRC]
            + libjpeg_link_args())


def ensure_built() -> str:
    """Compile the decoder unless a library with this build's key exists;
    return the .so path. The build writes a private temporary file and
    renames it into place, so concurrent first uses are safe."""
    args = _build_args()
    lib = os.path.join(BUILD_DIR, f"_meterelf_jpeg-{build_key(args)}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(args + ["-o", tmp], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"native JPEG decoder build failed:\n{r.stderr[-3000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


if __name__ == "__main__":
    print(ensure_built())
