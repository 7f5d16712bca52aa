"""fei_tpu_torch against fei_tpu: the scenarios of tests/test_memdir.py run on the port's copy, then the
cross-package checks at the end of this file.

Memdir subsystem tests: store atomicity, search QL, filters, archiver,
folders, HTTP server (in-process), CLI."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import os
import time
import urllib.request

import pytest

from fei_tpu_torch.memory.memdir.archiver import MemoryArchiver, Rule
from fei_tpu_torch.memory.memdir.filters import FilterManager, MemoryFilter
from fei_tpu_torch.memory.memdir.folders import MemdirFolderManager
from fei_tpu_torch.memory.memdir.search import (
    format_results,
    parse_search_args,
    search_memories,
)
from fei_tpu_torch.memory.memdir.store import (
    MemdirStore,
    generate_filename,
    parse_filename,
    parse_memory_file,
    render_memory_file,
)
from fei_tpu_torch.utils.errors import MemoryError_


@pytest.fixture
def store(tmp_path):
    return MemdirStore(str(tmp_path / "Memdir"))


class TestStore:
    def test_filename_roundtrip(self):
        name = generate_filename("FS")
        meta = parse_filename(name)
        assert meta is not None and meta["flags"] == "FS"

    def test_file_codec(self):
        raw = render_memory_file({"Subject": "s", "Tags": "a,b"}, "body\ntext")
        headers, body = parse_memory_file(raw)
        assert headers == {"Subject": "s", "Tags": "a,b"}
        assert body == "body\ntext"

    def test_save_is_atomic_delivery(self, store):
        mem = store.save("hello world", tags=["x"])
        new_dir = os.path.join(store.base, "new")
        assert os.listdir(new_dir) == [mem.filename]
        assert os.listdir(os.path.join(store.base, "tmp")) == []

    def test_get_and_mark_seen(self, store):
        mem = store.save("content here")
        got = store.get(mem.id)
        assert got.content == "content here" and got.status == "new"
        seen = store.mark_seen(mem.id)
        assert seen.status == "cur" and "S" in seen.flags
        assert store.get(mem.id).status == "cur"

    def test_move_across_folders(self, store):
        mem = store.save("task item")
        moved = store.move(mem.id, ".Projects")
        assert moved.folder == ".Projects" and moved.status == "cur"
        assert store.list("", "new") == []

    def test_flags_rewrite(self, store):
        mem = store.save("x", flags="S")
        updated = store.update_flags(mem.id, "FP")
        assert updated.flags == "FP"

    def test_soft_delete_to_trash(self, store):
        mem = store.save("bye")
        assert store.delete(mem.id)
        assert store.get(mem.id).folder == ".Trash"

    def test_hard_delete(self, store):
        mem = store.save("gone")
        assert store.delete(mem.id, hard=True)
        assert store.get(mem.id) is None

    def test_folder_traversal_rejected(self, store):
        with pytest.raises(MemoryError_):
            store.folder_path("../evil")

    def test_rewrite_headers(self, store):
        mem = store.save("body", headers={"Subject": "old"})
        store.rewrite_headers(mem.id, {"Status": "done"})
        got = store.get(mem.id)
        assert got.headers["Status"] == "done" and got.content == "body"


class TestSearch:
    def seed(self, store):
        store.save("python decorators are neat", tags=["python", "learning"])
        store.save("urgent: fix the build", flags="FP",
                   headers={"Subject": "urgent: fix the build"})
        store.save("grocery list: milk", tags=["personal"])
        m = store.save("old note about jax")
        # backdate the old note by renaming with an old timestamp
        old_name = m.filename
        parts = old_name.split(".")
        parts[0] = str(int(time.time()) - 120 * 86400)
        new_name = ".".join(parts)
        os.rename(os.path.join(store.base, "new", old_name),
                  os.path.join(store.base, "new", new_name))

    def test_keyword_or(self, store):
        self.seed(store)
        q = parse_search_args("python milk")
        res = search_memories(store, q)
        assert len(res) == 2

    def test_tag_and_flag_filters(self, store):
        self.seed(store)
        assert len(search_memories(store, parse_search_args("#python"))) == 1
        assert len(search_memories(store, parse_search_args("+F"))) == 1

    def test_field_conditions(self, store):
        self.seed(store)
        res = search_memories(store, parse_search_args("Subject:urgent"))
        assert len(res) == 1
        assert len(search_memories(store, parse_search_args("status=new"))) == 4
        assert search_memories(store, parse_search_args("status!=new")) == []

    def test_relative_date(self, store):
        self.seed(store)
        res = search_memories(store, parse_search_args("date<now-90d"))
        assert len(res) == 1 and "jax" in res[0].content

    def test_regex_and_limit_sort(self, store):
        self.seed(store)
        res = search_memories(store, parse_search_args(r"/fix the \w+/"))
        assert len(res) == 1
        res = search_memories(store, parse_search_args("sort:date limit:2"))
        assert len(res) == 2
        assert res[0].timestamp <= res[1].timestamp  # ascending sort

    def test_formats(self, store):
        self.seed(store)
        mems = search_memories(store, parse_search_args("#python"))
        assert "python" in format_results(mems, "compact")
        parsed = json.loads(format_results(mems, "json"))
        assert parsed[0]["tags"] == ["python", "learning"]
        assert format_results(mems, "csv").startswith("id,folder")


class TestFilters:
    def test_default_rules_route_and_promote(self, store):
        store.save("learning python generators today")
        store.save("just a plain note")
        stats = FilterManager(store).process_memories()
        assert stats["processed"] == 2
        # python memory moved to .Projects/Python with tag
        routed = store.list(".Projects/Python", "cur", with_content=True)
        assert len(routed) == 1 and "python" in routed[0].tags
        # plain note promoted new→cur in place
        assert len(store.list("", "cur")) == 1
        assert store.list("", "new") == []

    def test_custom_filter_flags(self, store):
        store.save("deploy tonight", headers={"Subject": "urgent deploy"})
        filt = MemoryFilter("urgent", {"Subject": "urgent"}, {"flag": "F"})
        FilterManager(store, [filt]).process_memories()
        mems = store.list("", "cur")
        assert mems and "F" in mems[0].flags


class TestArchiver:
    def _backdate(self, store, mem, days):
        parts = mem.filename.split(".")
        parts[0] = str(int(time.time()) - days * 86400)
        new_name = ".".join(parts)
        os.rename(os.path.join(store.folder_path(mem.folder), mem.status, mem.filename),
                  os.path.join(store.folder_path(mem.folder), mem.status, new_name))

    def test_age_archive(self, store):
        old = store.save("ancient wisdom")
        self._backdate(store, old, 120)
        store.save("fresh note")
        stats = MemoryArchiver(store).archive_old_memories()
        assert stats["archived"] == 1
        year = time.localtime(time.time() - 120 * 86400).tm_year
        assert len(store.list(f".Archive/{year}", "cur")) == 1

    def test_trash_expiry_counts_from_trashing_not_creation(self, store):
        old = store.save("created long ago")
        self._backdate(store, old, 120)
        old = store.get(old.id)
        store.delete(old.id)  # just moved to trash now
        # same maintenance pass must NOT delete it: 0 days in trash
        assert MemoryArchiver(store).empty_trash() == 0
        assert store.get(old.id) is not None
        # once it has sat in trash past trash_days it goes
        removed = MemoryArchiver(store).empty_trash(now=time.time() + 45 * 86400)
        assert removed == 1 and store.get(old.id) is None

    def test_rule_tag_trash(self, store):
        store.save("scratch", tags=["tmp"])
        arch = MemoryArchiver(store)
        arch.add_rule(Rule("tmp-to-trash", tags=["tmp"], action="trash"))
        stats = arch.archive_old_memories()
        assert stats["trashed"] == 1

    def test_retention_evicts_least_important(self, store):
        keep = store.save("keep me", flags="P")
        store.save("evict me 1")
        store.save("evict me 2")
        evicted = MemoryArchiver(store).apply_retention("", max_memories=1)
        assert evicted == 2
        assert store.get(keep.id).folder == ""

    def test_status_rewrite(self, store):
        store.save("[x] finished the thing")
        updated = MemoryArchiver(store).update_statuses()
        assert updated == 1
        mems = store.list("", "new", with_content=True)
        assert mems[0].headers["Status"] == "completed"


class TestFolders:
    def test_create_normalizes_dot(self, store):
        mgr = MemdirFolderManager(store)
        assert mgr.create_folder("Projects/Go") == ".Projects/Go"
        assert ".Projects/Go" in mgr.list_folders()

    def test_delete_protects_special_and_preserves(self, store):
        mgr = MemdirFolderManager(store)
        with pytest.raises(MemoryError_):
            mgr.delete_folder(".Trash")
        mgr.create_folder("Tmp")
        mem = store.save("in tmp", folder=".Tmp")
        with pytest.raises(MemoryError_):
            mgr.delete_folder("Tmp")
        mgr.delete_folder("Tmp", force=True)
        assert store.get(mem.id).folder == ".Trash"

    def test_rename_and_stats(self, store):
        mgr = MemdirFolderManager(store)
        mgr.create_folder("A")
        store.save("x", folder=".A", flags="F", tags=["t1"])
        mgr.rename_folder("A", "B")
        stats = mgr.get_folder_stats("B")
        assert stats["total"] == 1 and stats["by_flag"]["F"] == 1
        assert stats["by_tag"] == {"t1": 1}

    def test_copy_and_bulk_tag(self, store):
        mgr = MemdirFolderManager(store)
        store.save("one")
        store.save("two")
        assert mgr.copy_folder("", "Backup") == 2
        assert mgr.bulk_tag_folder("Backup", ["archived"]) == 2
        mems = store.list(".Backup", "new", with_content=True)
        assert all("archived" in m.tags for m in mems)

    def test_make_symlinks(self, store):
        """Dot-less navigation links (parity: ref folders.py:382)."""
        import os

        mgr = MemdirFolderManager(store)
        mgr.create_folder("Projects/Go")
        links = mgr.make_symlinks()
        by_name = {os.path.relpath(l, os.path.join(store.base, "links")): l
                   for l in links}
        assert "Projects/Go" in by_name
        link = by_name["Projects/Go"]
        assert os.path.islink(link)
        assert os.path.realpath(link) == os.path.realpath(
            store.folder_path(".Projects/Go")
        )
        # idempotent: second run refreshes, never errors
        assert sorted(mgr.make_symlinks()) == sorted(links)
        # refuses to clobber a real file
        clobber = os.path.join(store.base, "links", "Real")
        open(clobber, "w").write("x")
        mgr.create_folder("Real")
        with pytest.raises(MemoryError_):
            mgr.make_symlinks()


class TestServer:
    @pytest.fixture
    def server(self, tmp_path):
        from fei_tpu_torch.memory.memdir.server import MemdirServer

        srv = MemdirServer(str(tmp_path / "Memdir"), port=0, api_key="testkey")
        srv.start_background()
        yield srv
        srv.shutdown()

    def _req(self, server, method, path, body=None, key="testkey"):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}",
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"X-API-Key": key, "Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    def test_health_no_auth(self, server):
        status, body = self._req(server, "GET", "/health", key="wrong")
        assert status == 200 and body["status"] == "ok"

    def test_auth_required(self, server):
        status, body = self._req(server, "GET", "/memories", key="wrong")
        assert status == 401

    def test_crud_cycle(self, server):
        status, body = self._req(server, "POST", "/memories",
                                 {"content": "via http", "tags": ["api"]})
        assert status == 201
        mid = body["memory"]["id"]
        status, body = self._req(server, "GET", f"/memories/{mid}")
        assert status == 200 and body["memory"]["content"] == "via http"
        status, body = self._req(server, "PUT", f"/memories/{mid}",
                                 {"folder": ".Projects"})
        assert status == 200 and body["memory"]["folder"] == ".Projects"
        status, body = self._req(server, "DELETE", f"/memories/{mid}")
        assert status == 200
        status, body = self._req(server, "GET", f"/memories/{mid}")
        assert body["memory"]["folder"] == ".Trash"

    def test_search_endpoint(self, server):
        self._req(server, "POST", "/memories",
                  {"content": "searchable python text", "tags": ["python"]})
        status, body = self._req(
            server, "GET", "/search?q=%23python&with_content=true"
        )
        assert status == 200 and body["count"] == 1
        assert "searchable" in body["results"][0]["content"]

    def test_folders_and_filters(self, server):
        status, body = self._req(server, "POST", "/folders", {"name": "Inbox"})
        assert status == 201 and body["folder"] == ".Inbox"
        status, body = self._req(server, "GET", "/folders")
        assert ".Inbox" in body["folders"]
        self._req(server, "POST", "/memories", {"content": "python rocks"})
        status, body = self._req(server, "POST", "/filters/run", {})
        assert status == 200 and body["stats"]["processed"] == 1


class TestCLI:
    def test_create_list_search_view(self, tmp_path, capsys):
        from fei_tpu_torch.memory.memdir.cli import main

        base = str(tmp_path / "Memdir")
        assert main(["--base", base, "create", "hello from cli",
                     "--tags", "cli,demo"]) == 0
        out = capsys.readouterr().out
        mid = out.split()[1]
        assert main(["--base", base, "list"]) == 0
        assert "hello from cli" in capsys.readouterr().out
        assert main(["--base", base, "search", "#cli"]) == 0
        assert mid in capsys.readouterr().out
        assert main(["--base", base, "view", mid]) == 0
        assert "hello from cli" in capsys.readouterr().out
        # view marks seen → promoted to cur
        assert main(["--base", base, "list", "--status", "cur"]) == 0
        assert mid in capsys.readouterr().out


class TestSamples:
    def test_create_samples_populates_folders(self, tmp_path):
        from fei_tpu_torch.memory.memdir.samples import create_samples
        from fei_tpu_torch.memory.memdir.search import parse_search_args, search_memories
        from fei_tpu_torch.memory.memdir.store import MemdirStore

        store = MemdirStore(str(tmp_path / "Memdir"))
        n = create_samples(store)
        assert n == 20
        folders = store.list_folders()
        for f in ("", ".Projects", ".ToDoLater", ".Archive", ".Trash"):
            assert f in folders
        assert len(search_memories(store, parse_search_args("#tpu"))) >= 3
        # archive folder got its seeded entries
        archived = search_memories(store, parse_search_args("folder:.Archive"))
        assert len(archived) >= 2


# ----------------------------------------------------- across the packages

@pytest.mark.parametrize("writer,reader", [("fei_tpu", "fei_tpu_torch"),
                                           ("fei_tpu_torch", "fei_tpu")])
def test_memdir_written_by_one_package_reads_in_the_other(writer, reader, tmp_path):
    """A Memdir is Maildir files on disk: either package's store reads the
    other's with the same headers, content, flags, status and folders."""
    import importlib

    w = importlib.import_module(f"{writer}.memory.memdir.store").MemdirStore(
        str(tmp_path / "Memdir"))
    r = importlib.import_module(f"{reader}.memory.memdir.store").MemdirStore(
        str(tmp_path / "Memdir"))
    a = w.save("first body\nline two", headers={"Subject": "one"}, tags=["x", "y"])
    b = w.save("flagged", flags="FS", folder=".Projects")
    w.move(a.id, ".Archive")
    c = w.save("seen")
    w.mark_seen(c.id)
    assert r.list_folders() == w.list_folders()
    for mem in (a, b, c):
        mine, theirs = w.get(mem.id), r.get(mem.id)
        assert theirs is not None
        assert (theirs.filename, theirs.folder, theirs.status, theirs.flags) == (
            mine.filename, mine.folder, mine.status, mine.flags)
        assert theirs.headers == mine.headers and theirs.content == mine.content
    # the reader's own writes land where the writer finds them
    d = r.save("from the reader", tags=["z"])
    assert w.get(d.id).content == "from the reader"
    for folder in w.list_folders():
        for status in ("new", "cur"):
            assert ([m.filename for m in r.list(folder, status)]
                    == [m.filename for m in w.list(folder, status)])
