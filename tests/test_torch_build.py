"""The kernel build's cache: a library already built is reused with the
report nvcc wrote when it was built, so a second run in the same checkout
reads the same ptxas report as the first; a library without its report is
built again.  No ``nvcc`` runs here: a reused library needs none, and the
rebuild runs a stand-in that writes the library and prints a report."""

import os
import stat
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

#: the part of a ptxas report that chip_smoke's build phase reads
REPORT = textwrap.dedent("""\
    ptxas info    : Compiling entry function '_Z23flash_fwd_kernel_wgmmaILi96EEvPK' for 'sm_90a'
    ptxas info    : Function properties for _Z23flash_fwd_kernel_wgmmaILi96EEvPK
        0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
    ptxas info    : Used 168 registers, used 1 barriers, 552 bytes cmem[0]
    """)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_info", {})
    return tmp_path


def test_a_cached_library_carries_its_ptxas_report(build_dir, monkeypatch):
    lib = build._target("flash_attention")
    assert lib.parent == build_dir
    lib.write_bytes(b"\x7fELF")
    build._log_path(lib).write_text(REPORT)
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("a cached library ran nvcc"))
    assert build._start("flash_attention") is None
    info = build.build_info["flash_attention"]
    assert info == {"seconds": 0.0, "log": REPORT}
    rows = chip_smoke._ptxas_report(info["log"])
    assert rows == [("_Z23flash_fwd_kernel_wgmmaILi96EEvPK", 168, 0, 0)]
    assert any("flash_fwd_kernel_wgmmaILi96E" in fn for fn, *_ in rows)


def test_a_library_without_its_report_is_built_again(build_dir, monkeypatch, tmp_path_factory):
    lib = build._target("flash_attention")
    lib.write_bytes(b"stale")
    nvcc = tmp_path_factory.mktemp("bin") / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "wb").write(b"rebuilt")
        sys.stdout.write({REPORT!r})
        """))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    job = build._start("flash_attention")
    assert job is not None
    build._finish(job)
    assert lib.read_bytes() == b"rebuilt"
    assert build._log_path(lib).read_text() == REPORT
    assert build.build_info["flash_attention"]["log"] == REPORT
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [lib.name, build._log_path(lib).name])
    # and the next start reuses it, report included
    assert build._start("flash_attention") is None
    assert build.build_info["flash_attention"]["log"] == REPORT
