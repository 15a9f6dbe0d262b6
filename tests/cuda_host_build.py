"""A CUDA source's device part built for the host over
``tests/cuda_host/cuda_host.h``: shared by ``tests/test_torch_kernel_host.py``
(the solver iteration) and ``tests/test_torch_probe_host.py`` (the probes)."""
import re
import shutil
import subprocess
from pathlib import Path

import pytest

HOST = Path(__file__).resolve().parent / "cuda_host"
# where a cp.async copy lands: at the wait that covers it, or when it is
# started (cuda_host.h); the card may land it anywhere between the two
LANDING = {"at_wait": [], "at_start": ["-DCP_ASYNC_AT_START"]}


def host_source(source: Path, copies: dict, replace: dict) -> str:
    """The .cu file's device part as host C++: cut before the C interface,
    the runtime header swapped for the host stand-in, each key of
    ``replace`` (which must occur) swapped for its value, and the inline-PTX
    copy helpers named in ``copies`` given the bodies there (cuda_host.h's
    queued copies)."""
    src = source.read_text()
    src = src[:src.index('extern "C" {')]
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_host.h"')
    for old, new in replace.items():
        assert old in src, old
        src = src.replace(old, new)
    found = []

    def body(mt):
        found.append(mt.group(1))
        return (f"__device__ __forceinline__ void {mt.group(1)}({mt.group(2)}) "
                f"{{ {copies[mt.group(1)]} }}")

    src = re.sub(r"__device__ __forceinline__ void (cp_async\w*)\(([^)]*)\) \{.*?\n\}",
                 body, src, flags=re.S)
    assert sorted(found) == sorted(copies), found
    return src


def build_host(tmp: Path, header: str, source: str, main: str) -> dict:
    """One binary per ``LANDING`` from ``main`` (a file of tests/cuda_host/,
    which includes ``header``) with ``source`` written as ``header``, the
    builds started together; skips where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    (tmp / header).write_text(source)
    for f in ("cuda_host.h", main):
        shutil.copy(HOST / f, tmp / f)
    out = {k: tmp / f"{Path(main).stem}_{k}" for k in LANDING}
    builds = [subprocess.Popen([gxx, "-O1", "-std=c++20", "-ffp-contract=off",
                                "-pthread", *flags, "-o", str(out[k]), str(tmp / main)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
              for k, flags in LANDING.items()]
    for p in builds:
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log.decode()[-4000:]
    return out
