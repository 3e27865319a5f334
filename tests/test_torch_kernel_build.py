"""The CUDA build list against the sources in `acestep_tpu_torch/csrc` (CPU only).

`cuda_lib.library_path` names a library by a digest of its source and of the
headers in `cuda_lib._HEADERS`; a header missing from that list would leave a
stale library after the header is edited. These tests read the sources and
need no `nvcc`.
"""

import re

import pytest

from acestep_tpu_torch.ops import cuda_lib

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _quoted_includes(path):
    return set(_INCLUDE.findall(path.read_text()))


@pytest.mark.parametrize("name", cuda_lib.SOURCES)
def test_every_quoted_include_is_in_the_digest(name):
    src = cuda_lib.SRC_DIR / f"{name}.cu"
    seen, todo = set(), _quoted_includes(src)
    while todo:  # headers that include headers
        h = todo.pop()
        seen.add(h)
        todo |= _quoted_includes(cuda_lib.SRC_DIR / h) - seen
    assert seen <= set(cuda_lib._HEADERS), sorted(seen - set(cuda_lib._HEADERS))


def test_every_listed_source_exists():
    for name in cuda_lib.SOURCES:
        assert (cuda_lib.SRC_DIR / f"{name}.cu").is_file(), name
    for h in cuda_lib._HEADERS:
        assert (cuda_lib.SRC_DIR / h).is_file(), h


def test_every_source_is_listed():
    on_disk = {p.stem for p in cuda_lib.SRC_DIR.glob("*.cu")}
    assert on_disk == set(cuda_lib.SOURCES)


def test_editing_a_header_renames_the_library(tmp_path, monkeypatch):
    for p in cuda_lib.SRC_DIR.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(cuda_lib, "SRC_DIR", tmp_path)
    before = {n: cuda_lib.library_path(n) for n in cuda_lib.SOURCES}
    with open(tmp_path / "attention_sm90.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_lib.library_path(n) for n in cuda_lib.SOURCES}
    users = [n for n in cuda_lib.SOURCES if "attention_sm90.cuh" in (tmp_path / f"{n}.cu").read_text()]
    assert users
    for n in users:
        assert before[n] != after[n], n
