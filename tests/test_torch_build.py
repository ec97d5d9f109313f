"""The kernel libraries' build digest, on the CPU (no nvcc needed).

``build.library_path`` names a library by a digest of every ``.cu`` and
``.cuh`` under its source's ``csrc/`` directory and of nvcc's flags, so an
edited header or flag builds a new library instead of loading a stale one.
"""

import pytest

from repro_torch.kernels import build


@pytest.fixture
def lib(tmp_path, monkeypatch):
    """A fake library ``demo`` whose source includes a header."""
    csrc = tmp_path / "demo" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "demo.cu").write_text('#include "common.cuh"\nextern "C" int f() { return g(); }\n')
    (csrc / "common.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setitem(build.SOURCES, "demo", csrc / "demo.cu")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_digest_covers_headers_sources_and_flags(lib, monkeypatch):
    first = build.library_path("demo")
    assert first.parent == build.BUILD_DIR and first.name.startswith("libdemo_")
    assert build.library_path("demo") == first  # stable
    assert [p.name for p in build.digest_inputs("demo")] == ["common.cuh", "demo.cu"]

    (lib / "common.cuh").write_text("inline int g() { return 2; }\n")
    second = build.library_path("demo")
    assert second != first  # an edited header

    (lib / "notes.txt").write_text("not a source")
    assert build.library_path("demo") == second  # other files do not count

    (lib / "extra.cuh").write_text("// new header\n")
    third = build.library_path("demo")
    assert third != second  # a new header

    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("demo") != third  # a new flag


def test_every_library_digests_its_whole_csrc():
    for name, src in build.SOURCES.items():
        inputs = build.digest_inputs(name)
        assert src in inputs, name
        assert set(inputs) == {p for p in src.parent.iterdir() if p.suffix in (".cu", ".cuh")}
    # the two attention variants share a csrc/ directory, so each is rebuilt
    # when either source changes, and their libraries differ by name
    fa, tc = build.library_path("flash_attention"), build.library_path("flash_attention_wgmma")
    assert fa != tc and fa.name.startswith("libflash_attention_")
