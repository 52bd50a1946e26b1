"""The kernel build of the port (``engine/build.py``) without a CUDA toolkit.

nvcc runs only on a host with the card; here a stand-in compiler (a small
Python script) takes its place, so that the build's own logic is checked:
one library per ``csrc/*.cu``, names that change with any source (headers
included), the cache, and a failure that names its source and leaves no
partial file behind.
"""

import stat
import sys

import pytest

from rustfhe_tpu_torch.engine import build

FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
time.sleep(0.2)
if "broken" in src:
    print("error: " + src)
    sys.exit(2)
open(out, "w").write("library of " + src)
print("ptxas info    : Used 1 registers, compiled " + src)
"""


def test_sources_are_the_kernel_files():
    assert [s.stem for s in build.sources()] == ["cmux_k", "int8_gemm", "karatsuba_probe",
                                                 "limb_probe", "limb_step", "rotate_all_k"]
    assert build.library_path("cmux_k").name.startswith("libcmux_k-")


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a")
    (csrc / "b.cu").write_text("// b")
    (csrc / "common.cuh").write_text("// shared")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    return csrc, out


def test_build_one_library_per_source_then_cached(fake_tree):
    csrc, out = fake_tree
    libs = build.build()
    assert sorted(libs) == ["a", "b"]
    for name, (path, report) in libs.items():
        assert path.parent == out and path.read_text().endswith(f"{name}.cu")
        assert "Used 1 registers" in report
    again = build.build()
    assert {k: v[0] for k, v in again.items()} == {k: v[0] for k, v in libs.items()}
    assert all(report == "" for _, report in again.values())
    # A change to the shared header renames (and so rebuilds) every library.
    (csrc / "common.cuh").write_text("// changed")
    renamed = build.build()
    assert all(renamed[k][0] != libs[k][0] and renamed[k][1] for k in libs)


def test_build_failure_names_the_source(fake_tree):
    csrc, out = fake_tree
    (csrc / "broken.cu").write_text("// does not compile")
    with pytest.raises(RuntimeError, match="broken.cu: nvcc failed"):
        build.build()
    assert sorted(p.suffix for p in out.iterdir()) == [".so", ".so"]  # a and b only
    assert not any("broken" in p.name for p in out.iterdir())


def test_load_needs_a_card(monkeypatch):
    monkeypatch.setattr(build.torch.cuda, "is_available", lambda: False)
    build.load.cache_clear()
    with pytest.raises(RuntimeError, match="is_available"):
        build.load("rotate_all_k")
