"""The port's router journal (``serve/journal.py``) on the CPU.

Counterpart: ``tests/serve/test_journal.py``: append/replay round trip
with monotonic seqs, torn-tail drop and heal, snapshot compaction with
exactly-once replay across the crash window, and the degrade-never-crash
path for an unreadable snapshot. Then the format across the packages: the
same records framed byte for byte, and a journal written by either
package (torn tail and snapshot included) replays in the other.
"""

import json
import os
import zlib

import pytest

from torcheval_tpu import obs as jax_obs
from torcheval_tpu.serve import journal as jax_journal
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.serve import journal as port_journal
from torcheval_tpu_torch.serve.journal import RouterJournal
from torcheval_tpu_torch.utils.test_utils import obs_counts


def _wal(directory):
    return os.path.join(directory, "wal.log")


def _snap(directory):
    return os.path.join(directory, "snapshot.json")


@pytest.fixture
def obs_on():
    obs.reset()
    obs.enable()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture
def d(tmp_path):
    return str(tmp_path / "journal")


def _seed(d, *tenants):
    j = RouterJournal(d)
    for t in tenants:
        j.append("place", tenant=t)
    j.close()


def _replay(d, cls=RouterJournal):
    j = cls(d)
    out = j.replay()
    j.close()
    return out


# --- round trip -------------------------------------------------------------

def test_append_replay_round_trip(d):
    j = RouterJournal(d)
    j.append("place", tenant="a", endpoint="e1")
    j.append("move", tenant="a", endpoint="e2")
    j.append("remove", tenant="a")
    j.close()
    snapshot, records = _replay(d)
    assert snapshot is None
    assert [(r["kind"], r.get("endpoint")) for r in records] == [
        ("place", "e1"), ("move", "e2"), ("remove", None)
    ]


def test_seqs_are_monotonic_across_reopens(d):
    j = RouterJournal(d)
    s1 = j.append("place", tenant="a")
    s2 = j.append("place", tenant="b")
    j.close()
    j2 = RouterJournal(d)
    s3 = j2.append("place", tenant="c")
    j2.close()
    assert s1 < s2 < s3


def test_append_on_closed_journal_raises(d):
    j = RouterJournal(d)
    j.close()
    with pytest.raises(ValueError):
        j.append("place", tenant="a")
    with pytest.raises(ValueError):
        j.compact({})
    j.close()  # idempotent


def test_empty_directory_replays_empty(d):
    assert _replay(d) == (None, [])


def test_records_counter_labeled_by_kind(d, obs_on):
    j = RouterJournal(d)
    j.append("place", tenant="a")
    j.append("place", tenant="b")
    j.append("split", tenant="a", replicas=["a@r1"])
    j.close()
    assert obs_counts.count("serve.router.journal_records", kind="place") == 2
    assert obs_counts.count("serve.router.journal_records", kind="split") == 1


# --- torn tails -------------------------------------------------------------

def test_torn_tail_dropped_and_counted_not_raised(d, obs_on):
    _seed(d, "x", "y")
    with open(_wal(d), "ab") as f:
        f.write(b"deadbeef {torn mid-wri")  # no newline: torn write
    _, records = _replay(d)
    assert [r["tenant"] for r in records] == ["x", "y"]
    assert obs_counts.count("serve.router.journal_torn_tails", reason="wal") == 1


def test_crc_mismatch_dropped(d):
    _seed(d, "x")
    body = b'{"kind":"place","seq":99,"tenant":"evil"}'
    with open(_wal(d), "ab") as f:
        f.write(b"%08x %s\n" % (0x12345678, body))  # wrong CRC
    _, records = _replay(d)
    assert [r["tenant"] for r in records] == ["x"]


def test_append_after_tear_heals(d):
    # the reopen must truncate the torn bytes before appending, or the new
    # record glues onto the garbage and is dropped with it at the next replay
    _seed(d, "x", "y")
    with open(_wal(d), "ab") as f:
        f.write(b"deadbeef {torn")
    j = RouterJournal(d)
    j.append("place", tenant="z")
    j.close()
    _, records = _replay(d)
    assert [r["tenant"] for r in records] == ["x", "y", "z"]


def test_everything_after_a_tear_is_dropped(d):
    _seed(d, "x")
    good = json.dumps(
        {"kind": "place", "seq": 50, "tenant": "late"}, sort_keys=True, separators=(",", ":")
    ).encode()
    with open(_wal(d), "ab") as f:
        f.write(b"nothexxx not-a-record\n")
        f.write(b"%08x %s\n" % (zlib.crc32(good) & 0xFFFFFFFF, good))
    _, records = _replay(d)
    assert [r["tenant"] for r in records] == ["x"]


@pytest.mark.parametrize(
    "line",
    [b"", b"00000000\n", b"0000000 {}\n", b"zzzzzzzz {}\n", b"%08x []\n" % zlib.crc32(b"[]")],
    ids=["empty", "no_body", "short_head", "bad_hex", "not_a_dict"],
)
def test_parse_line_refuses_like_jax(line):
    assert port_journal._parse_line(line) is None
    assert jax_journal._parse_line(line) is None


# --- compaction -------------------------------------------------------------

def test_compact_publishes_snapshot_and_truncates_wal(d, obs_on):
    j = RouterJournal(d)
    j.append("place", tenant="a")
    j.append("place", tenant="b")
    j.compact({"tenants": {"a": {}, "b": {}}})
    j.append("place", tenant="c")
    j.close()
    assert os.path.getsize(_wal(d)) > 0
    snapshot, records = _replay(d)
    assert snapshot == {"tenants": {"a": {}, "b": {}}}
    assert [r["tenant"] for r in records] == ["c"]
    assert obs_counts.count("serve.router.journal_compactions") == 1


def test_replay_skips_records_folded_into_snapshot(d):
    # crash window: snapshot published, WAL not yet truncated
    j = RouterJournal(d)
    j.append("place", tenant="a")
    j.append("place", tenant="b")
    j.close()
    with open(_wal(d), "rb") as f:
        stale_wal = f.read()
    j2 = RouterJournal(d)
    j2.compact({"folded": True})
    j2.close()
    with open(_wal(d), "wb") as f:
        f.write(stale_wal)
    assert _replay(d) == ({"folded": True}, [])


def test_auto_compaction_via_snapshot_fn(d):
    j = RouterJournal(d, snapshot_fn=lambda: {"auto": True}, compact_every=3)
    j.append("place", tenant="a")
    j.append("place", tenant="b")
    assert not os.path.exists(_snap(d))
    j.append("place", tenant="c")  # third record: auto-compact
    assert os.path.exists(_snap(d))
    j.append("place", tenant="d")
    j.close()
    snapshot, records = _replay(d)
    assert snapshot == {"auto": True}
    assert [r["tenant"] for r in records] == ["d"]


def test_unreadable_snapshot_degrades_to_wal(d, obs_on):
    j = RouterJournal(d)
    j.append("place", tenant="a")
    j.compact({"fine": 1})
    j.append("place", tenant="b")
    j.close()
    with open(_snap(d), "wb") as f:
        f.write(b"{not json at all")
    j2 = RouterJournal(d)
    snapshot, records = j2.replay()
    j2.append("place", tenant="c")  # still appendable after the degraded load
    j2.close()
    assert snapshot is None
    assert [r["tenant"] for r in records] == ["b"]
    assert obs_counts.count("serve.router.journal_torn_tails", reason="snapshot") == 1


def test_tmp_snapshot_from_crashed_compaction_is_harmless(d):
    _seed(d, "a")
    with open(_snap(d) + ".tmp", "wb") as f:
        f.write(b"half-written garbage")
    snapshot, records = _replay(d)
    assert snapshot is None
    assert [r["tenant"] for r in records] == ["a"]


# --- across the packages ----------------------------------------------------

PACKAGES = {"jax": jax_journal.RouterJournal, "port": RouterJournal}

RECORDS = [
    ("host_add", {"endpoint": "127.0.0.1:9001"}),
    ("place", {"tenant": "a", "endpoint": "127.0.0.1:9001",
               "spec": {"acc": ["MulticlassAccuracy", {"num_classes": 5}]},
               "knobs": {"max_queue": 4}, "parent": None}),
    ("place", {"tenant": "a@r1", "endpoint": "127.0.0.1:9002",
               "spec": {"acc": ["MulticlassAccuracy", {"num_classes": 5}]},
               "knobs": {}, "parent": "a"}),
    ("split", {"tenant": "a", "replicas": ["a", "a@r1"]}),
    ("move", {"tenant": "a", "endpoint": "127.0.0.1:9002"}),
    ("host_drain", {"endpoint": "127.0.0.1:9001"}),
    ("remove", {"tenant": "a@r1"}),
]


def _write(cls, d, compact_after=None, state=None):
    j = cls(d)
    for i, (kind, fields) in enumerate(RECORDS):
        j.append(kind, **fields)
        if compact_after == i:
            j.compact(state)
    j.close()


@pytest.mark.parametrize("record", range(len(RECORDS)))
def test_frames_are_the_jax_packages_byte_for_byte(record):
    kind, fields = RECORDS[record]
    rec = {"seq": record + 1, "kind": kind, **fields}
    assert port_journal._frame(rec) == jax_journal._frame(rec)
    assert port_journal._parse_line(jax_journal._frame(rec)) == rec


def test_both_packages_write_the_same_files(tmp_path):
    state = {"tenants": {"a": {"endpoint": "e"}}, "endpoints": ["e"], "drained": []}
    for name, cls in PACKAGES.items():
        _write(cls, str(tmp_path / name), compact_after=2, state=state)
    for f in ("wal.log", "snapshot.json"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("tear", [False, True], ids=["clean", "torn"])
def test_a_journal_replays_in_the_other_package(tmp_path, writer, reader, tear):
    d = str(tmp_path / "j")
    state = {"tenants": {"s": {"endpoint": "e"}}, "endpoints": ["e"], "drained": ["e"]}
    _write(PACKAGES[writer], d, compact_after=1, state=state)
    if tear:
        with open(_wal(d), "ab") as f:
            f.write(b"0badc0de {\"kind\":\"place\",\"se")
    snapshot, records = _replay(d, PACKAGES[reader])
    assert snapshot == state
    assert [(r["kind"], r["seq"]) for r in records] == [
        (kind, i + 1) for i, (kind, _) in enumerate(RECORDS) if i > 1
    ]
    assert records[0]["tenant"] == "a@r1" and records[0]["parent"] == "a"
    # the reader healed the tear: the other package appends and replays
    j = PACKAGES[reader](d)
    seq = j.append("place", tenant="late")
    j.close()
    assert seq == len(RECORDS) + 1
    _, again = _replay(d, PACKAGES[writer])
    assert again[-1]["tenant"] == "late" and len(again) == len(records) + 1


def test_torn_tail_counts_in_the_readers_registry(tmp_path, obs_on):
    d = str(tmp_path / "j")
    _write(jax_journal.RouterJournal, d)
    with open(_wal(d), "ab") as f:
        f.write(b"deadbeef {torn")
    jax_obs.reset()
    _replay(d)
    assert obs_counts.count("serve.router.journal_torn_tails", reason="wal") == 1
    assert not jax_obs.snapshot()["counters"]
