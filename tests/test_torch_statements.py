"""The port's three doors — ``Repo``, statement strings and the
``datagit`` CLI (``python -m repro_torch.vcs_cli``) — against each other
and against the reference.

The 16-step workflow of ``tests/test_statements_cli.py`` (as
``chip_smoke.door_steps``, which the card runs too) goes through each
door of the port (``--device cpu``) and through the reference's ``Repo``:
the fingerprints (ts, table digests, commit log, branches, snapshots, PRs)
must be equal, and every statement's result text must equal the
reference's. A statement session's WAL replays to the same fingerprint.
The statement layer's typed errors and did-you-mean suggestions equal the
reference's, and the CLI tests of ``tests/test_statements_cli.py`` that
need no fsck or remote have their counterparts here.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.statements as R_stmt
import repro.vcs_cli as R_cli
import repro_torch.core as P
import repro_torch.core.statements as P_stmt
import repro_torch.vcs_cli as P_cli
from chip_smoke import content_digest as digest
from chip_smoke import door_fingerprint as fingerprint
from chip_smoke import door_steps as steps

STMT = {"ref": R_stmt, "port": P_stmt}
CLI = {"ref": R_cli, "port": P_cli}


def new_repo(side):
    return R.Repo() if side == "ref" else P.Repo(device="cpu")


def drive_python(side):
    r = new_repo(side)
    for py, _, _ in steps(CLI[side]):
        py(r)
    return r


def drive_statements(side, messages=None):
    r = new_repo(side)
    for py, stmt, _ in steps(CLI[side]):
        if stmt is None:
            py(r)
        else:
            res = STMT[side].execute(r, stmt)
            if messages is not None:
                messages.append((stmt, res.kind, res.message))
    return r


def cli_main(side, store, argv):
    dev = ["--device", "cpu"] if side == "port" else []
    return CLI[side].main(dev + ["--store", store] + argv)


def load(side, store):
    if side == "ref":
        return R_cli.load_repo(store)
    return P_cli.load_repo(store, "cpu")


def drive_cli(side, tmp_path):
    store = str(tmp_path / f"{side}.wal")
    assert cli_main(side, store, ["init"]) == 0
    for _, _, argv in steps(CLI[side]):
        assert cli_main(side, store, argv) == 0, argv
    return load(side, store)


# ------------------------------------------------------------ three doors

def test_golden_three_surface_parity_within_the_port(tmp_path):
    fp_py = fingerprint(drive_python("port"))
    fp_stmt = fingerprint(drive_statements("port"))
    fp_cli = fingerprint(drive_cli("port", tmp_path))
    assert fp_py == fp_stmt, "python vs statement door diverged"
    assert fp_py == fp_cli, "python vs CLI door diverged"


def test_each_port_door_equals_the_reference_repo(tmp_path):
    want = fingerprint(drive_python("ref"))
    assert fingerprint(drive_python("port")) == want
    assert fingerprint(drive_statements("port")) == want
    assert fingerprint(drive_cli("port", tmp_path)) == want


def test_statement_result_texts_equal_the_reference():
    ref_msgs, port_msgs = [], []
    drive_statements("ref", ref_msgs)
    drive_statements("port", port_msgs)
    assert [m[:2] for m in port_msgs] == [m[:2] for m in ref_msgs]
    for (stmt, _, got), (_, _, want) in zip(port_msgs, ref_msgs):
        assert got == want, stmt


def test_status_keys_and_metric_names_equal_the_reference():
    st_ref = drive_python("ref").status()
    st_port = drive_python("port").status()
    assert list(st_port) == list(st_ref)
    assert list(st_port["metrics"]) == list(st_ref["metrics"])
    for k in ("ts", "tables", "branches", "snapshots", "prs", "crc32c"):
        assert st_port[k] == st_ref[k], k
    assert st_port["store"]["packed"] == 0
    assert st_port["store"]["packs"] is None
    assert st_port["metrics"] == st_ref["metrics"]


def test_statement_session_wal_replays_identically():
    r = drive_statements("port")
    e2 = P.Engine.replay(P.WAL.deserialize(r.engine.wal.serialize()),
                         device="cpu")
    assert fingerprint(P.Repo(e2)) == fingerprint(r)
    assert fingerprint(P.Repo(e2)) == fingerprint(drive_statements("ref"))


def test_cli_device_default_is_the_card(tmp_path, capsys):
    """Without ``--device`` the CLI runs on the card; with none present it
    exits 2 with a typed error and writes no store."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    store = str(tmp_path / "s.wal")
    assert P_cli.main(["--store", store, "init"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    assert not os.path.exists(store)


# ------------------------------------------------------- statement layer

def _messages(side):
    r = new_repo(side)
    CLI[side].seed_table(r, "t", 50, 0)
    out = STMT[side].execute_script(
        r, "CREATE SNAPSHOT s FOR TABLE t; CREATE BRANCH d FOR (t); "
           "SHOW BRANCHES; SHOW SNAPSHOTS; SHOW TABLES; SHOW PRS; STATUS")
    return [(o.kind, o.message) for o in out]


def test_execute_script_and_messages():
    ref, port = _messages("ref"), _messages("port")
    assert [k for k, _ in port] == ["create_snapshot", "create_branch",
                                    "show", "show", "show", "show",
                                    "status"]
    assert "branch d created" in port[1][1]
    assert port == ref


BAD_STATEMENTS = [
    "MERG BRANCH a INTO b",
    "DIFF TABLE t",
    "PUBLISH PR notanumber",
    "CREATE BRANCH b FOR (t) trailing",
    "CREAT BRANCH x",
    "SHOW BRANCH",
    "EXPLAIN EXPLAIN GC",
    "EXPLAIN FROB",
    "CLONE TABLE x FROM",
    "REVERT TABLE t FRM 'a' TO 'b'",
    "GC; STATUS",
    "DIFF 'a",
]


@pytest.mark.parametrize("text", BAD_STATEMENTS)
def test_statement_errors_and_suggestions_equal_the_reference(text):
    got = {}
    for side in ("ref", "port"):
        r = new_repo(side)
        CLI[side].seed_table(r, "t", 10, 0)
        with pytest.raises(STMT[side].StatementError) as exc:
            STMT[side].execute(r, text)
        got[side] = (str(exc.value), exc.value.suggestions)
    assert got["port"] == got["ref"]
    if text.startswith("MERG "):
        assert "MERGE" in got["port"][1]


def test_ref_errors_pass_through_typed():
    for side, api in (("ref", R), ("port", P)):
        r = new_repo(side)
        CLI[side].seed_table(r, "t", 10, 0)
        with pytest.raises(api.UnknownRefError):
            STMT[side].execute(r, "DIFF TABLE t AGAINST 'snap:missing'")


@pytest.mark.parametrize("text, verb", [
    ("FSCK", "FSCK"), ("FSCK REPAIR", "FSCK"), ("LINT", "LINT"),
    ("PUSH TO '/tmp/remote'", "PUSH"), ("PULL FROM '/tmp/remote'", "PULL"),
    ("FETCH FROM '/tmp/remote'", "FETCH")])
def test_fsck_lint_and_remote_statements_run_as_in_the_reference(
        text, verb, tmp_path):
    """FSCK, PUSH, PULL and FETCH give the reference's result kind and
    text (the remote is a temporary directory, pushed to first where the
    statement reads one). LINT lints each package's own tree: the result
    kind is ``lint`` in both, and the port's findings and text are its
    runner's over ``src/repro_torch``."""
    if verb == "LINT":
        kinds = {}
        for side in ("ref", "port"):
            r = new_repo(side)
            CLI[side].seed_table(r, "t", 10, 0)
            res = STMT[side].execute(r, text)
            kinds[side] = res.kind
        assert kinds == {"ref": "lint", "port": "lint"}
        findings, message = _port_lint()
        assert res.data == findings and res.message == message
        assert "0 finding(s)" in res.message
        return
    got = {}
    for side in ("ref", "port"):
        r = new_repo(side)
        CLI[side].seed_table(r, "t", 10, 0)
        remote = str(tmp_path / side / "remote")
        if verb in ("PULL", "FETCH"):
            STMT[side].execute(r, f"PUSH TO '{remote}'")
        res = STMT[side].execute(r, text.replace("/tmp/remote", remote))
        got[side] = (res.kind, res.message.replace(remote, "<remote>"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == verb.lower()


def test_repo_verbs_and_lint_run_through_every_door(tmp_path, capsys):
    """``Repo.fsck/push/pull/fetch`` run on the port, and so does the last
    door verb, lint: the ``LINT`` statement and ``datagit lint`` give the
    port's runner's findings and text, and the CLI exits 0 on the clean
    tree."""
    r = new_repo("port")
    P_cli.seed_table(r, "t", 10, 0)
    remote = str(tmp_path / "remote")
    assert r.fsck().ok
    assert r.push(remote)["objects_pushed"] == len(set(r.engine.store.oids()))
    assert r.fetch(remote)["objects_pulled"] == 0
    assert r.pull(remote)["up_to_date"]
    findings, message = _port_lint()
    res = P_stmt.execute(r, "LINT")
    assert (res.kind, res.data, res.message) == ("lint", findings, message)
    store = _init(tmp_path)
    capsys.readouterr()
    assert cli_main("port", store, ["lint"]) == 0
    assert capsys.readouterr() == (message + "\n", "")


def _diff_direction(side):
    r = new_repo(side)
    CLI[side].seed_table(r, "t", 20, 0)
    STMT[side].execute(r, "CREATE SNAPSHOT s FOR TABLE t")
    r.insert("t", CLI[side]._demo_batch(np.arange(20, 25), 1))
    res = STMT[side].execute(r, "DIFF TABLE t AGAINST 'snap:s'")
    d = res.data
    return int((d.diff_cnt > 0).sum()), int((d.diff_cnt < 0).sum()), \
        res.message


def test_diff_table_statement_direction():
    ref, port = _diff_direction("ref"), _diff_direction("port")
    assert port[:2] == (5, 0)
    assert port == ref


@pytest.mark.parametrize("mode, want", [("ours", 1.0), ("theirs", 2.0)])
def test_statement_conflict_modes_alias(mode, want):
    r = new_repo("port")
    r.create_table("t", P_cli.DEMO_SCHEMA)
    r.insert("t", {"k": np.asarray([1]), "v": np.asarray([0.0]),
                   "doc": [b"x"]})
    P_stmt.execute(r, "CREATE BRANCH d FOR (t)")
    r.update_by_keys("t", {"k": np.asarray([1]), "v": np.asarray([1.0]),
                           "doc": [b"x"]})
    r.update_by_keys("d/t", {"k": np.asarray([1]), "v": np.asarray([2.0]),
                             "doc": [b"x"]})
    P_stmt.execute(r, f"MERGE BRANCH d INTO main MODE {mode}")
    batch, _ = r.table("t").scan()
    assert batch["v"].tolist() == [want]


def _atomic_merge(side):
    r = new_repo(side)
    cli = CLI[side]
    cli.seed_table(r, "a", 30, 0)
    cli.seed_table(r, "b", 30, 1)
    STMT[side].execute(r, "CREATE BRANCH d FOR (a, b)")
    cli.mutate_table(r, "d/a", 5, 2)
    cli.mutate_table(r, "d/b", 5, 3)
    res = STMT[side].execute(r, "MERGE BRANCH d INTO main")
    reports = res.data
    assert set(reports) == {"a", "b"}
    assert reports["a"].commit_ts == reports["b"].commit_ts is not None
    assert r.engine.table("a").directory.ts == \
        r.engine.table("b").directory.ts == reports["a"].commit_ts
    return res.message, fingerprint(r)


def test_branch_merge_is_atomic_multi_table():
    assert _atomic_merge("port") == _atomic_merge("ref")


def _explain(side):
    r = new_repo(side)
    CLI[side].seed_table(r, "t", 30, 0)
    STMT[side].execute(r, "CREATE SNAPSHOT s FOR TABLE t")
    CLI[side].mutate_table(r, "t", 5, 1)
    res = STMT[side].execute(r, "EXPLAIN DIFF TABLE t AGAINST 'snap:s'")
    first, *rest = res.message.splitlines()
    # span names and nesting, without the times and counter values
    tree = [ln.split("  [")[0] for ln in rest if "[" in ln]
    return first, tree, [s.name for s in res.data["spans"]]


def test_explain_renders_the_reference_span_tree():
    ref, port = _explain("ref"), _explain("port")
    assert port[1] and port[2] == ["diff"]
    assert port == ref


def test_explain_inside_an_armed_tracer_nests_under_explain():
    r = new_repo("port")
    P_cli.seed_table(r, "t", 30, 0)
    with P.telemetry.trace(r.engine) as tr:
        res = P_stmt.execute(r, "EXPLAIN GC")
    assert [s.name for s in tr.roots] == ["explain"]
    assert [s.name for s in res.data["spans"]] == ["gc"]
    assert "gc  [" in res.message


def test_tag_refuses_non_head_with_clean_error():
    r = new_repo("port")
    P_cli.seed_table(r, "t", 10, 0)
    r.insert("t", P_cli._demo_batch(np.arange(10, 12), 1))
    with pytest.raises(ValueError, match="not the current head"):
        r.tag("old", "t~1")
    with pytest.raises(ValueError, match="not the current head"):
        r.tag("old", "t@{1}")
    assert r.tag("head1", "t").table == "t"
    P_stmt.execute(r, "CREATE SNAPSHOT head2 FOR TABLE t")
    r.restore("t", "t~1")
    r.tag("head3", "t~0")


def test_legacy_shim_prefers_snapshots_and_survives_pregrammar_names():
    r = new_repo("port")
    P_cli.seed_table(r, "t", 10, 0)
    with pytest.raises(KeyError):
        r.engine.resolve_snapshot("t")
    r.engine.create_snapshot("night ly", "t", _log=False)
    assert r.engine.resolve_snapshot("night ly").table == "t"
    r.engine.create_snapshot("t~1", "t", _log=False)
    assert r.engine.resolve_snapshot("t~1") is r.engine.snapshots["t~1"]


def test_merge_into_table_wins_over_branch_name_collision():
    r = new_repo("port")
    P_cli.seed_table(r, "x", 10, 0)
    r.tag("s", "x")
    r.engine.create_branch("x", ["x"])
    rep = P_stmt.execute(r, "MERGE 'snap:s' INTO TABLE x MODE theirs").data
    assert rep.inserted == 0 and rep.deleted == 0


def test_branch_merge_disjoint_tables_is_an_error():
    r = new_repo("port")
    P_cli.seed_table(r, "a", 10, 0)
    P_cli.seed_table(r, "b", 10, 1)
    P_stmt.execute(r, "CREATE BRANCH x FOR (a)")
    P_stmt.execute(r, "CREATE BRANCH y FOR (b)")
    with pytest.raises(ValueError, match="share no tables"):
        P_stmt.execute(r, "MERGE BRANCH x INTO y")


def test_table_position_wins_over_name_collision():
    r = new_repo("port")
    P_cli.seed_table(r, "orders", 30, 0)
    r.tag("orders", "orders")
    assert [e.kind for e in r.log("orders")][-1] == "create"
    assert P_stmt.execute(r, "LOG TABLE orders").data
    P_cli.mutate_table(r, "orders", 5, 1)
    P_stmt.execute(r, "REVERT TABLE orders FROM 'orders~1' TO 'HEAD'")
    P_stmt.execute(r, "MERGE 'snap:orders' INTO TABLE orders MODE theirs")


# ------------------------------------------------------------------- CLI

def _port_lint():
    """The port runner's findings over its own tree, and their text."""
    from repro_torch.analysis import (default_paths, discover_count,
                                      render_text, repo_root, run_analysis)
    root = repo_root()
    paths = default_paths(root)
    findings = run_analysis(paths, root=root)
    return findings, render_text(findings, discover_count(paths))


def _init(tmp_path, side="port"):
    store = str(tmp_path / f"{side}-s.wal")
    assert cli_main(side, store, ["init"]) == 0
    return store


def test_demo_data_equals_the_reference_rows():
    for seed in (0, 3):
        got = P_cli._demo_batch(np.arange(7), seed)
        want = R_cli._demo_batch(np.arange(7), seed)
        assert got["k"].tolist() == want["k"].tolist()
        assert got["v"].tolist() == want["v"].tolist()
        assert got["doc"] == want["doc"]
    fps = []
    for side in ("ref", "port"):
        r = new_repo(side)
        CLI[side].seed_table(r, "t", 40, 2, nopk=True)
        CLI[side].seed_table(r, "u", 40, 2)
        CLI[side].mutate_table(r, "u", 9, 4)
        fps.append(fingerprint(r))
    assert fps[0] == fps[1]


def test_cli_error_exit_code_and_hint(tmp_path, capsys):
    store = _init(tmp_path)
    assert cli_main("port", store, ["seed", "orders", "--rows", "20"]) == 0
    assert cli_main("port", store, ["snapshot", "night", "orders"]) == 0
    rc = cli_main("port", store, ["diff", "snap:nigt", "HEAD",
                                  "--table", "orders"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "no snapshot" in err and "night" in err


def test_cli_sql_subcommand_persists_mutations(tmp_path):
    store = _init(tmp_path)
    assert cli_main("port", store, ["seed", "orders", "--rows", "20"]) == 0
    assert cli_main("port", store, [
        "sql", "CREATE BRANCH dev FOR (orders); "
               "CREATE SNAPSHOT night FOR TABLE orders"]) == 0
    r = load("port", store)
    assert [b[0] for b in r.branches()] == ["dev"]
    assert [s[0] for s in r.snapshots()] == ["night"]


def test_cli_pr_check_exit_code_gates(tmp_path, capsys):
    store = _init(tmp_path)
    cli_main("port", store, ["seed", "t", "--rows", "30"])
    cli_main("port", store, ["branch", "dev", "-t", "t"])
    cli_main("port", store, ["mutate", "dev/t", "--rows", "5", "--seed",
                             "1"])
    cli_main("port", store, ["pr", "open", "dev"])
    assert cli_main("port", store, ["pr", "check", "1"]) == 0
    cli_main("port", store, ["mutate", "t", "--rows", "5", "--seed", "2"])
    rc = cli_main("port", store, ["pr", "check", "1"])
    out = capsys.readouterr().out
    assert rc == 1 and "FAILED" in out


def test_cli_sql_check_exit_code_gates(tmp_path):
    store = _init(tmp_path)
    cli_main("port", store, ["seed", "t", "--rows", "30"])
    cli_main("port", store, ["branch", "dev", "-t", "t"])
    cli_main("port", store, ["mutate", "dev/t", "--rows", "5", "--seed",
                             "1"])
    cli_main("port", store, ["mutate", "t", "--rows", "5", "--seed", "2"])
    cli_main("port", store, ["pr", "open", "dev"])
    rc = cli_main("port", store, ["sql", "CREATE SNAPSHOT pre FOR TABLE t; "
                                         "CHECK PR 1"])
    assert rc == 1
    assert [s[0] for s in load("port", store).snapshots()] == ["pre"]


def test_cli_merge_accepts_qualified_branch_refs(tmp_path):
    store = _init(tmp_path)
    cli_main("port", store, ["seed", "t", "--rows", "20"])
    cli_main("port", store, ["branch", "dev", "-t", "t"])
    cli_main("port", store, ["mutate", "dev/t", "--rows", "3", "--seed",
                             "1"])
    assert cli_main("port", store, ["merge", "branch:dev", "branch:main",
                                    "--mode", "theirs"]) == 0
    cli_main("port", store, ["snapshot", "s", "t"])
    assert cli_main("port", store, ["merge", "snap:s", "t", "-t",
                                    "t"]) == 2


def test_cli_rejects_keyword_injection_in_name_positions(tmp_path, capsys):
    store = _init(tmp_path)
    cli_main("port", store, ["seed", "prod", "--rows", "10"])
    assert cli_main("port", store, ["branch", "dev FOR (prod)"]) == 2
    assert "invalid branch name" in capsys.readouterr().err
    assert load("port", store).branches() == []
    assert cli_main("port", store, ["log", "prod LIMIT 1"]) == 2


def test_cli_pkviolation_is_a_clean_error(tmp_path, capsys):
    store = _init(tmp_path)
    assert cli_main("port", store, ["seed", "t", "--rows", "5"]) == 0
    assert cli_main("port", store, ["seed", "t", "--rows", "5"]) == 2
    assert "error:" in capsys.readouterr().err


def test_cli_torn_store_tail_is_dropped_not_appended_after(tmp_path,
                                                           capsys):
    store = _init(tmp_path)
    assert cli_main("port", store, ["seed", "t", "--rows", "10"]) == 0
    with open(store, "ab") as f:
        f.write(b"\x80")                      # torn frame: 1 stray byte
    assert cli_main("port", store, ["branch", "dev", "-t", "t"]) == 0
    assert "torn trailing frame" in capsys.readouterr().err
    with open(store + ".corrupt", "rb") as f:
        assert f.read() == b"\x80"
    r = load("port", store)
    assert [b[0] for b in r.branches()] == ["dev"]


def test_cli_missing_store_is_an_error(tmp_path, capsys):
    store = str(tmp_path / "strore.wal")
    assert cli_main("port", store, ["seed", "orders", "--rows", "5"]) == 2
    assert "no store at" in capsys.readouterr().err
    assert not os.path.exists(store)


def test_cli_store_persists_and_replays(tmp_path):
    store = _init(tmp_path)
    cli_main("port", store, ["seed", "t", "--rows", "30"])
    cli_main("port", store, ["branch", "dev", "-t", "t"])
    cli_main("port", store, ["mutate", "dev/t", "--rows", "5", "--seed",
                             "3"])
    r1 = load("port", store)
    mtime = os.path.getmtime(store)
    size = os.path.getsize(store)
    assert cli_main("port", store, ["status"]) == 0
    assert cli_main("port", store, ["log", "t"]) == 0
    assert os.path.getmtime(store) == mtime
    r2 = load("port", store)
    assert digest(r1.engine, "dev/t") == digest(r2.engine, "dev/t")
    assert r1.engine.ts == r2.engine.ts
    # a mutating command appends one frame: O(Δ), the old bytes untouched
    with open(store, "rb") as f:
        old = f.read()
    cli_main("port", store, ["snapshot", "s", "t"])
    with open(store, "rb") as f:
        new = f.read()
    assert new[:size] == old and len(new) > size
    frames = list(P.wal.iter_frames(new, len(P.wal.STORE_HEADER)))
    assert len(frames) == 5                   # init + 4 mutating commands


def test_cli_legacy_headerless_store_loads_and_upgrades(tmp_path):
    """A headerless pickle stream loads once; the next mutating command
    rewrites the store in the framed format."""
    import pickle
    r = new_repo("port")
    P_cli.seed_table(r, "t", 12, 0)
    store = str(tmp_path / "legacy.wal")
    with open(store, "wb") as f:
        f.write(pickle.dumps(P.WAL.deserialize(
            r.engine.wal.serialize()).records))
    assert fingerprint(load("port", store)) == fingerprint(r)
    assert cli_main("port", store, ["snapshot", "s", "t"]) == 0
    with open(store, "rb") as f:
        assert f.read(4) == b"DGWS"
    assert [s[0] for s in load("port", store).snapshots()] == ["s"]


@pytest.mark.parametrize("argv", [
    ["fsck"], ["fsck", "--repair"], ["lint"], ["push", "/tmp/remote"],
    ["pull", "/tmp/remote"], ["fetch", "/tmp/remote"],
    ["clone", "/tmp/remote"]])
def test_cli_durability_and_lint_subcommands_run(tmp_path, capsys, argv):
    """Every subcommand runs and exits 0 (the remote is a temporary
    directory, pushed to first where the subcommand reads one; a repo
    clone makes a new store). ``lint`` exits as the reference's does: 0
    on each package's clean tree, 1 on a tree with a planted finding (a
    bare sort in the hot merge module of either package)."""
    store = _init(tmp_path)
    if argv == ["lint"]:
        codes = {}
        for side, pkg in (("ref", "repro"), ("port", "repro_torch")):
            bad = tmp_path / side / "src" / pkg / "core" / "merge.py"
            bad.parent.mkdir(parents=True)
            bad.write_text("import numpy as np\nx = np.unique(y)\n")
            s = store if side == "port" else _init(tmp_path, "ref")
            codes[side] = (cli_main(side, s, argv),
                           cli_main(side, s, argv + [str(tmp_path / side)]))
        assert codes == {"ref": (0, 1), "port": (0, 1)}
        assert "hidden-sort" in capsys.readouterr().out
        return
    remote = str(tmp_path / "remote")
    argv = [remote if a == "/tmp/remote" else a for a in argv]
    assert cli_main("port", store, ["seed", "t", "--rows", "20"]) == 0
    if argv[0] in ("pull", "fetch", "clone"):
        assert cli_main("port", store, ["push", remote]) == 0
    if argv[0] == "clone":
        store = str(tmp_path / "clone.wal")
    assert cli_main("port", store, argv) == 0, argv
    assert capsys.readouterr().err == ""
    src = str(tmp_path / "port-s.wal")
    assert fingerprint(load("port", store))["tables"]["t"] == \
        fingerprint(load("port", src))["tables"]["t"]


def test_cli_refs_mode_store_exits_with_a_typed_error(tmp_path, capsys):
    """A refs-mode store loads from its refs snapshot now; a refs file
    that is not one (here: empty) is refused with the typed format error,
    exit 2."""
    store = _init(tmp_path)
    open(store + ".refs", "wb").close()
    assert cli_main("port", store, ["status"]) == 2
    assert "not a datagit refs snapshot" in capsys.readouterr().err


def test_cli_trace_writes_a_chrome_trace(tmp_path):
    import json
    store = _init(tmp_path)
    out = str(tmp_path / "trace.json")
    assert P_cli.main(["--device", "cpu", "--store", store, "--trace", out,
                       "seed", "t", "--rows", "20"]) == 0
    events = json.load(open(out))
    names = [ev["name"] for ev in events]
    assert names[0] == "cli.seed" and "replay" in names
    assert "commit" in names
