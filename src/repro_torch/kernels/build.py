"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own (all ``nvcc`` processes
start together) into ``build/kernels/lib<name>.so`` at the repository
root; a source with two entry points (``SPLIT``) compiles once per entry
(``-DFCP_ENTRY=1``, ``2``), all at once, and its two objects link into
the one library.  The interface is plain C: every pointer and the stream travel as
``c_void_p``, and each entry point returns ``cudaGetLastError()``.
The first time a process asks for the libraries it loads the ones in
``build/kernels`` if their stamp, the digest of everything that goes into
them (every file of ``csrc``, the flags, ``nvcc``'s path and its
``--version``), is that of the checkout; else it rebuilds them all and
writes the stamp after the last one, so a stale build is never loaded
(the ranks of a ``torchrun`` load what their parent built).  Building through ``torch.utils.cpp_extension`` is avoided on purpose:
sources that include PyTorch's headers take minutes to compile, these
take seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
STAMP = BUILD_DIR / "stamp"       # the digest the libraries were built at
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

SOURCES = ("fused_flash_fwd", "flash_attention_fwd", "fused_flash_bwd_dq",
           "fused_flash_bwd_dkv", "flash_attention_bwd")
# the sources whose two entry points compile apart (their nvcc took
# 41-43 s and 59-71 s whole on an H100 host, the others 21-32 s)
SPLIT = ("flash_attention_fwd", "flash_attention_bwd")


def sources_digest(nvcc: str) -> str:
    """The build's identity: every file of ``csrc``, the flags, and the
    compiler (``nvcc``'s path and what its ``--version`` prints)."""
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(repr((NVCC_FLAGS, SPLIT, SOURCES, nvcc,
                             version)).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the "
            "CUDA kernels are built from kernels/csrc at first use")
    return found


class _Libraries:
    """The loaded kernel libraries of this process (built once)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: dict[str, ctypes.CDLL] = {}
        self.build_seconds: float | None = None
        self.build_log: dict[str, str] = {}
        self.source_seconds: dict[str, float] = {}    # each nvcc's wall

    def build(self) -> float:
        """Compile every source in parallel; returns the wall seconds."""
        with self._lock:
            if self.build_seconds is None:
                self._build_locked()
            return self.build_seconds

    def _build_locked(self) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        digest = sources_digest(nvcc)
        if (STAMP.exists() and STAMP.read_text() == digest
                and all((BUILD_DIR / f"lib{n}.so").exists()
                        for n in SOURCES)):
            self.build_seconds = time.perf_counter() - t0
            return

        def private(suffix):
            # compile to a private name, then rename: concurrent builders
            # never load a half-written library
            fd, path = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
            os.close(fd)
            return path

        def run(cmds):
            """The commands, all at once: (all passed, their output)."""
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
            outs = [p.communicate()[0] for p in procs]
            return all(p.returncode == 0 for p in procs), "".join(outs)

        def compile_source(name, tmp):
            src = str(CSRC / f"{name}.cu")
            if name not in SPLIT:
                ok, out = run([[nvcc, *NVCC_FLAGS, "-o", tmp, src]])
            else:
                objs = [private(".o") for _ in range(2)]
                flags = [f for f in NVCC_FLAGS if f != "-shared"]
                ok, out = run([[nvcc, *flags, "-c", f"-DFCP_ENTRY={i + 1}",
                                "-o", obj, src]
                               for i, obj in enumerate(objs)])
                if ok:
                    ok, link = run([[nvcc, *NVCC_FLAGS[:2], "-shared",
                                     "-o", tmp, *objs]])
                    out += link
                for obj in objs:
                    os.unlink(obj)
            self.build_log[name] = out
            self.source_seconds[name] = time.perf_counter() - t0
            oks[name] = ok

        tmps = {name: private(".so") for name in SOURCES}
        oks: dict[str, bool] = {}
        workers = [threading.Thread(target=compile_source,
                                    args=(name, tmps[name]))
                   for name in SOURCES]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        failed = []
        STAMP.unlink(missing_ok=True)
        for name, tmp in tmps.items():
            if oks.get(name):
                os.replace(tmp, BUILD_DIR / f"lib{name}.so")
            else:
                failed.append(name)
                os.unlink(tmp)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(self.build_log[n] for n in failed))
        tmp = private(".stamp")
        Path(tmp).write_text(digest)
        os.replace(tmp, STAMP)
        self.build_seconds = time.perf_counter() - t0

    def get(self, name: str) -> ctypes.CDLL:
        self.build()
        with self._lock:
            if name not in self._libs:
                self._libs[name] = ctypes.CDLL(
                    str(BUILD_DIR / f"lib{name}.so"))
            return self._libs[name]


LIBRARIES = _Libraries()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use)."""
    return LIBRARIES.get(name)
