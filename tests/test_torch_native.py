"""fei_tpu_torch against fei_tpu: the scenarios of tests/test_native.py run on the port's copy, then the
cross-package checks at the end of this file.

Native C++ scan engine: build, correctness vs the Python scan path, and
the fallback contract (regex patterns and disabled-native return None)."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import os

import pytest

from fei_tpu_torch.native import scan
from fei_tpu_torch.native.build import lib_path
from fei_tpu_torch.tools.code import GrepTool


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    (root / "a.py").write_text(
        "def alpha():\n    return beta()\n\ndef beta():\n    return 1\n"
    )
    (root / "b.txt").write_text("beta appears here\nand beta again\n")
    (root / "sub").mkdir()
    (root / "sub" / "c.py").write_text("gamma = beta\n")
    (root / "bin.dat").write_bytes(b"\x00\x01beta\x00")
    return root


class TestBuild:
    def test_builds_and_caches(self):
        p1 = lib_path()
        if p1 is None:
            pytest.skip("no C++ compiler in environment")
        assert os.path.exists(p1)
        assert lib_path() == p1  # cache hit, same artifact


class TestGrepFiles:
    def test_matches_python_scan(self, corpus):
        files = [
            str(corpus / "a.py"), str(corpus / "b.txt"),
            str(corpus / "sub" / "c.py"), str(corpus / "bin.dat"),
        ]
        got = scan.grep_files(files, "beta", max_results=100)
        if got is None:
            pytest.skip("native scan unavailable")
        want = GrepTool().search("beta", path=str(corpus))
        got_set = {(os.path.basename(f), n, t.strip()) for f, n, t in got}
        want_set = {
            (os.path.basename(m.file), m.line_number, m.line.strip())
            for m in want
        }
        assert got_set == want_set
        # binary file skipped
        assert not any("bin.dat" in f for f, _, _ in got)

    def test_one_match_per_line(self, corpus):
        got = scan.grep_files([str(corpus / "b.txt")], "beta", 100)
        if got is None:
            pytest.skip("native scan unavailable")
        assert [n for _, n, _ in sorted(got)] == [1, 2]

    def test_max_results_respected(self, corpus):
        files = [str(corpus / "a.py"), str(corpus / "b.txt")]
        got = scan.grep_files(files, "beta", max_results=2)
        if got is None:
            pytest.skip("native scan unavailable")
        assert len(got) == 2

    def test_regex_returns_none(self, corpus):
        assert scan.grep_files([str(corpus / "a.py")], r"beta\(", 10) is None
        assert scan.grep_files([str(corpus / "a.py")], "be.a", 10) is None

    def test_disabled_returns_none(self, corpus, monkeypatch):
        monkeypatch.setenv("FEI_TPU_NATIVE", "0")
        monkeypatch.setattr(scan, "_lib", None)
        try:
            assert scan.grep_files([str(corpus / "a.py")], "beta", 10) is None
        finally:
            scan._lib = None  # let other tests reload


class TestGrepToolIntegration:
    def test_fixed_string_search_through_tool(self, corpus):
        """GrepTool results are identical whether or not the native engine
        kicks in (it self-selects for fixed strings)."""
        matches = GrepTool().search("beta", path=str(corpus))
        assert {os.path.basename(m.file) for m in matches} == {
            "a.py", "b.txt", "c.py"
        }


class TestNulAfterSniff:
    def test_nul_in_line_past_sniff_window(self, tmp_path):
        """A NUL beyond the 4 KiB sniff must not truncate or over-read the
        matched line (POINTER(c_char) binding regression)."""
        clean = "x" * 5000 + "\n"
        payload = "beta before\x00after\n"
        p = tmp_path / "late_nul.txt"
        p.write_bytes(clean.encode() + payload.encode())
        got = scan.grep_files([str(p)], "beta", 10)
        if got is None:
            pytest.skip("native scan unavailable")
        assert len(got) == 1
        _, line_no, text = got[0]
        assert line_no == 2
        assert text == "beta before\x00after"


class TestOrderingParity:
    def test_grep_tool_native_sorted_like_python(self, tmp_path):
        import time as _time

        old = tmp_path / "old.py"
        new = tmp_path / "new.py"
        old.write_text("needle one\n")
        _time.sleep(0.05)
        new.write_text("needle two\n")
        matches = GrepTool().search("needle", path=str(tmp_path))
        # newest file first — the documented ordering contract
        assert [os.path.basename(m.file) for m in matches] == ["new.py", "old.py"]


# ----------------------------------------------------- across the packages

def _python_route(monkeypatch, pattern, root):
    """GrepTool's pure-Python route: the native engine switched off."""
    monkeypatch.setenv("FEI_TPU_NATIVE", "0")
    monkeypatch.setattr(scan, "_lib", None)
    try:
        return [(m.file, m.line_number, m.line) for m in GrepTool().search(pattern, path=root)]
    finally:
        scan._lib = None


@pytest.mark.parametrize("pattern", ["beta", "return", "def alpha"])
def test_scanner_equals_the_reference_and_the_python_route(corpus, pattern, monkeypatch):
    """The port's own scanner build gives the reference scanner's matches,
    and GrepTool through it gives the pure-Python route's matches in the
    same order."""
    from fei_tpu.native import scan as ref_scan
    from fei_tpu.native.build import lib_path as ref_lib_path

    files = sorted(str(p) for p in corpus.rglob("*") if p.is_file())
    ours = scan.grep_files(files, pattern, max_results=100)
    if ours is None:
        pytest.skip("no C++ compiler in environment")
    assert lib_path() != ref_lib_path()  # two caches, never one file
    assert sorted(ours) == sorted(ref_scan.grep_files(files, pattern, max_results=100))
    native = [(m.file, m.line_number, m.line)
              for m in GrepTool().search(pattern, path=str(corpus))]
    assert native == _python_route(monkeypatch, pattern, str(corpus))
