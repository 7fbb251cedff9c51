"""paddle_tpu_torch.cuda_build on the CPU, with a stand-in for nvcc: the
command line it runs, where a library lands, that an edited source or
local header gets a new library, and that a failed compile raises with
the compiler's output after every started compile has finished."""
import stat
import sys

import pytest

from paddle_tpu_torch import cuda_build
from paddle_tpu_torch.cuda_build import KernelLibrary, build

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open("{log}", "a") as f:
    f.write(" ".join(args) + "\\n")
if "{fail}" and any("{fail}" in a for a in args):
    print("error: {fail} does not compile")
    sys.exit(1)
open(args[args.index("-o") + 1], "wb").write(b"library")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    def make(fail=""):
        script = tmp_path / "nvcc"
        script.write_text(FAKE_NVCC.format(python=sys.executable,
                                           log=tmp_path / "calls.log",
                                           fail=fail))
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(script))
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
        return tmp_path / "calls.log"
    return make


def _source(tmp_path, name, text="extern \"C\" int f() { return 0; }"):
    src = tmp_path / f"{name}.cu"
    src.write_text(text)
    return KernelLibrary(src, {})


def test_builds_for_sm_90a_into_the_build_dir(tmp_path, fake_nvcc):
    log = fake_nvcc()
    lib = _source(tmp_path, "k")
    started = lib.start_build()
    lib.finish_build(started, 0.0)
    assert lib.path.read_bytes() == b"library"
    assert lib.path.parent == tmp_path / "_build"
    args = log.read_text().split()
    for flag in ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                 "-shared", "-Xcompiler", "-fPIC"):
        assert flag in args
    assert lib.start_build() is None  # built already: nothing to do


def test_an_edited_source_gets_a_new_library(tmp_path, fake_nvcc):
    fake_nvcc()
    lib = _source(tmp_path, "k")
    first = lib.path
    lib.source.write_text("extern \"C\" int f() { return 1; }")
    assert lib.path != first and lib.path.name.startswith("libk-")


def test_an_edited_local_header_gets_a_new_library(tmp_path, fake_nvcc):
    fake_nvcc()
    (tmp_path / "inc").mkdir()
    (tmp_path / "inc" / "common.cuh").write_text("#define X 1\n")
    (tmp_path / "inc" / "deeper.cuh").write_text("#define Y 1\n")
    (tmp_path / "inc" / "common.cuh").write_text(
        '#include "deeper.cuh"\n#define X 1\n')
    lib = _source(tmp_path, "k", '#include <cuda_runtime.h>\n'
                  '#include "inc/common.cuh"\nextern "C" int f();\n')
    assert [p.name for p in lib.sources()] == ["k.cu", "common.cuh",
                                               "deeper.cuh"]
    first = lib.path
    (tmp_path / "inc" / "deeper.cuh").write_text("#define Y 2\n")
    assert lib.path != first


def test_a_failed_compile_raises_after_every_compile(tmp_path, fake_nvcc):
    log = fake_nvcc(fail="bad")
    good, bad = _source(tmp_path, "good"), _source(tmp_path, "bad")
    with pytest.raises(RuntimeError, match="bad does not compile"):
        build([bad, good])
    assert len(log.read_text().splitlines()) == 2
    assert good.path.exists() and not bad.path.exists()
