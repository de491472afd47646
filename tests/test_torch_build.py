"""The kernel build's stamp (``repro_torch/kernels/build.py``): a process
loads the libraries in ``build/kernels`` only when their stamp is the
digest of everything that goes into them, and rebuilds them all
otherwise.

``nvcc`` is a stand-in shell script here (no CUDA toolkit on the CPU): it
logs its arguments, prints a version, writes whatever ``-o`` names and
fails when told to; the sources, the build directory and the stamp are a
test's own."""

import os

import pytest

from repro_torch.kernels import build

N_COMPILES = 9          # 3 sources whole, 2 split: 2 objects and a link


@pytest.fixture
def fake(tmp_path, monkeypatch):
    """The stand-in toolchain and sources; ``compiles()`` counts the
    ``nvcc`` calls that wrote a file so far."""
    bin_dir, csrc, out = (tmp_path / d for d in ("cuda/bin", "csrc", "out"))
    bin_dir.mkdir(parents=True)
    csrc.mkdir()
    for name in build.SOURCES:
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    log, version, fail = (tmp_path / f for f in ("log", "version", "fail"))
    version.write_text("nvcc: release 12.4\n")
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f"""#!/bin/sh
echo "$@" >> {log}
if [ "$1" = "--version" ]; then cat {version}; exit 0; fi
if [ -e {fail} ]; then echo "error: told to fail"; exit 1; fi
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
""")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "STAMP", out / "stamp")

    class Fake:
        def compiles(self):
            if not log.exists():
                return 0
            return sum(" -o " in f" {line} "
                       for line in log.read_text().splitlines())

        def build(self):
            build._Libraries().build()
            return self.compiles()

    f = Fake()
    f.csrc, f.out, f.version, f.fail = csrc, out, version, fail
    return f


def _edit_source(f):
    (f.csrc / f"{build.SOURCES[0]}.cu").write_text("// changed\n")


def _add_header(f):
    (f.csrc / "common.cuh").write_text("#pragma once\n")


def _new_compiler(f):
    f.version.write_text("nvcc: release 12.8\n")


def _drop_library(f):
    os.unlink(f.out / f"lib{build.SOURCES[-1]}.so")


def _new_flags(f, monkeypatch):
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))


CHANGES = {"nothing": (None, False), "source": (_edit_source, True),
           "header": (_add_header, True), "compiler": (_new_compiler, True),
           "library_missing": (_drop_library, True),
           "flags": (_new_flags, True)}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_build_is_loaded_only_at_its_stamp(change, fake, monkeypatch):
    assert fake.build() == N_COMPILES
    assert fake.out.joinpath("stamp").exists()
    fn, rebuilds = CHANGES[change]
    if fn is _new_flags:
        fn(fake, monkeypatch)
    elif fn is not None:
        fn(fake)
    assert fake.build() == N_COMPILES * (2 if rebuilds else 1)
    # and the rebuilt (or kept) libraries are loaded from now on
    assert fake.build() == N_COMPILES * (2 if rebuilds else 1)


def test_a_failed_build_leaves_no_stamp(fake):
    fake.build()
    _edit_source(fake)
    fake.fail.write_text("")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build._Libraries().build()
    assert not fake.out.joinpath("stamp").exists()
    fake.fail.unlink()
    before = fake.compiles()
    assert fake.build() == before + N_COMPILES
