"""The port's kernel build: which files a library is named by.

``build.library_path`` names each library by a hash of its source and of
``build.HEADERS``, so that an edited kernel is rebuilt and a stale library
is never loaded.  That holds only if every file a source includes is
hashed.  No nvcc is needed: these tests read the sources and hash copies.
"""
import re
import shutil

import pytest

from repro_torch.kernels import build

INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _local_includes(path):
    return INCLUDE.findall(path.read_text())


@pytest.mark.parametrize("name", build.SOURCES)
def test_every_local_include_is_hashed(name):
    """Each source, and each header it reaches, includes only files that
    are in build.HEADERS."""
    seen, todo = set(), [build.CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        for inc in _local_includes(path):
            assert inc in build.HEADERS, (
                f"{path.name} includes {inc!r}, which build.HEADERS does not "
                f"hash: an edit to it would leave a stale library loaded")
            if inc not in seen:
                seen.add(inc)
                todo.append(build.CSRC / inc)
    assert "common.cuh" in seen


def test_every_header_exists_and_every_csrc_file_is_built():
    for h in build.HEADERS:
        assert (build.CSRC / h).is_file(), h
    cu = {p.stem for p in build.CSRC.glob("*.cu")}
    assert cu == set(build.SOURCES)
    assert {p.name for p in build.CSRC.glob("*.cuh")} <= set(build.HEADERS)


@pytest.mark.parametrize("header", build.HEADERS)
def test_library_path_follows_each_header(tmp_path, monkeypatch, header):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    assert before == {name: build.library_path(name) for name in build.SOURCES}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    for name in build.SOURCES:
        assert build.library_path(name) != before[name], name
