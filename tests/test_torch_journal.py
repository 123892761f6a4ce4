"""``pbs_tpu_torch.gateway.{journal,recovery}`` against ``pbs_tpu``'s:
twins of ``tests/test_journal.py``, plus the cross-package checks.

- Every case of the reference test runs on the port: round trip and
  interning, the torn-tail property for EVERY byte prefix, CRC
  corruption as a hard error with its offset, recovery idempotence,
  single-gateway recovery books and order, reopen, the federation's
  lease audit across a kill-9, and ``pbst-torch journal verify|dump``
  with the reference's exit codes.
- The same scripted journaled run writes byte-identical journal files
  in both packages, and each package reads, replays and recovers the
  other's file to the same ``state_digest``, ``RecoveryInfo`` and
  restored queues (single gateway and federation).
- The commit path calls ``os.fsync`` at the same commits in both
  packages, counted under one seeded script at the registry's default
  cadence and at an explicit one, and on the torn-commit crash path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import types

import pytest

import pbs_tpu.gateway as ref_gw
import pbs_tpu_torch.gateway as port_gw
from pbs_tpu.cli.pbst import main as ref_main
from pbs_tpu.faults import injector as ref_faults
from pbs_tpu.gateway import journal as ref_journal
from pbs_tpu.gateway import recovery as ref_recovery
from pbs_tpu.utils import clock as ref_clock
from pbs_tpu_torch.cli.pbst import main
from pbs_tpu_torch.faults import injector as port_faults
from pbs_tpu_torch.gateway import (
    GatewayJournal,
    JournalCorrupt,
    SimServeBackend,
    read_journal,
    recover_gateway,
)
from pbs_tpu_torch.gateway import journal as port_journal
from pbs_tpu_torch.gateway import recovery as port_recovery
from pbs_tpu_torch.gateway.journal import HEADER_WORDS, Jr
from pbs_tpu_torch.gateway.recovery import (
    apply_recover_transform,
    replay,
    state_digest,
)
from pbs_tpu_torch.utils import clock as port_clock
from pbs_tpu_torch.utils.clock import MS

REF = types.SimpleNamespace(gw=ref_gw, journal=ref_journal,
                            recovery=ref_recovery, clock=ref_clock,
                            faults=ref_faults, name="ref")
PORT = types.SimpleNamespace(gw=port_gw, journal=port_journal,
                             recovery=port_recovery, clock=port_clock,
                             faults=port_faults, name="port")
BOTH = (REF, PORT)

LONG = "tenant-with-a-deliberately-long-name-x"


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    port_faults.uninstall()
    ref_faults.uninstall()


def _small_run_of(P, path, ticks: int = 24, **journal_kw):
    """The reference test's journaled single-gateway run, on package
    ``P``: admits, dispatches, completions and sheds on the record."""
    clock = P.clock.VirtualClock()
    journal = P.gw.GatewayJournal.create(path, **journal_kw)
    gw = P.gw.Gateway(
        [P.gw.SimServeBackend("b0", n_slots=2, service_ns_per_cost=3 * MS,
                              seed=1)],
        clock=clock, journal=journal)
    gw.register_tenant(LONG, P.gw.TenantQuota(
        rate=200.0, burst=20.0, slo="interactive", max_queued=4))
    gw.register_tenant("t1", P.gw.TenantQuota(rate=100.0, burst=40.0,
                                              slo="batch"))
    for i in range(ticks):
        gw.submit(LONG, None, cost=1 + i % 2)
        if i % 3 == 0:
            gw.submit("t1", None, cost=2 + i % 5)
        gw.tick()
        clock.advance(1 * MS)
    journal.commit()
    return path, clock, gw


def _small_run(tmp_path, ticks: int = 24):
    return _small_run_of(PORT, str(tmp_path / "gw.jrnl"), ticks)


def test_constants_match():
    for name in ("JOURNAL_MAGIC", "JOURNAL_ABI", "HEADER_WORDS",
                 "FRAME_MAGIC", "BATCH_CAPACITY", "FLUSH_NS",
                 "FSYNC_EVERY", "CHECKPOINT_PERIOD_NS", "MEMBER_EVENTS",
                 "SPEND_NONE", "SPEND_LEASED", "SPEND_CONSERVATIVE"):
        assert getattr(port_journal, name) == getattr(ref_journal, name)
    assert {j.name: int(j) for j in port_journal.Jr} == \
        {j.name: int(j) for j in ref_journal.Jr}
    for v in (0.0, 1.5, -2.25, 1e300, 3.0e-7):
        assert port_journal._f2w(v) == ref_journal._f2w(v)
        assert port_journal._w2f(port_journal._f2w(v)) == v


# -- the reference's cases, on the port ---------------------------------


def test_roundtrip_records_and_interning(tmp_path):
    path, _, gw = _small_run(tmp_path)
    view = read_journal(path)
    assert view.torn_bytes == 0
    assert view.generation == 0
    assert view.frames > 0
    ops = [r[1] for r in view.records]
    for op in (Jr.INTERN, Jr.MEMBER, Jr.TENANT, Jr.ADMIT, Jr.DISPATCH,
               Jr.COMPLETE):
        assert int(op) in ops, Jr(op).name
    names = [n for n, _ in port_journal.iter_interned(view.records)]
    assert LONG in names


def test_torn_tail_every_byte_prefix_recovers_or_refuses(tmp_path):
    """For EVERY byte prefix of a real journal, the port's reader yields
    an exact frame-aligned record prefix or refuses, and agrees with the
    reference's reader on every cut."""
    path, _, _ = _small_run(tmp_path, ticks=12)
    full = read_journal(path).records
    data = open(path, "rb").read()
    cut_path = str(tmp_path / "cut.jrnl")
    prefix_lens = set()
    for cut in range(len(data) + 1):
        with open(cut_path, "wb") as f:
            f.write(data[:cut])
        if cut < HEADER_WORDS * 8:
            with pytest.raises(JournalCorrupt):
                read_journal(cut_path)
            with pytest.raises(ref_journal.JournalCorrupt):
                ref_journal.read_journal(cut_path)
            continue
        view = read_journal(cut_path)
        k = len(view.records)
        assert view.records == full[:k], f"mis-recovery at cut {cut}"
        assert view.valid_bytes + view.torn_bytes == cut
        assert dataclasses.asdict(view) == dataclasses.asdict(
            ref_journal.read_journal(cut_path)), cut
        prefix_lens.add(k)
    assert len(prefix_lens) > 1
    assert len(full) in prefix_lens


def test_crc_corruption_is_hard_error_with_offset(tmp_path):
    path, _, _ = _small_run(tmp_path, ticks=8)
    data = bytearray(open(path, "rb").read())
    view = read_journal(path)
    mid_frame_rec = HEADER_WORDS * 8 + 8 + 3  # first record, frame 0
    for pos in (mid_frame_rec, view.valid_bytes - 4,
                view.valid_bytes - 20):
        bad = bytearray(data)
        bad[pos] ^= 0x40
        bad_path = str(tmp_path / "bad.jrnl")
        with open(bad_path, "wb") as f:
            f.write(bytes(bad))
        with pytest.raises(JournalCorrupt) as ei:
            read_journal(bad_path)
        assert ei.value.offset >= 0
        assert str(ei.value.offset) in str(ei.value)
        with pytest.raises(ref_journal.JournalCorrupt) as er:
            ref_journal.read_journal(bad_path)
        assert str(er.value) == str(ei.value)


def test_recovery_idempotence_same_state_digest(tmp_path):
    path, clock, _ = _small_run(tmp_path)
    a_path = str(tmp_path / "a.jrnl")
    b_path = str(tmp_path / "b.jrnl")
    shutil.copy(path, a_path)
    shutil.copy(path, b_path)
    _, info_a = recover_gateway(
        a_path, [SimServeBackend("b0", seed=7)], clock=clock)
    _, info_b = recover_gateway(
        b_path, [SimServeBackend("b0", seed=9)], clock=clock)
    assert info_a.state_digest == info_b.state_digest
    assert info_a.recovered == info_b.recovered
    view = read_journal(path)
    s1 = replay(view.records, 0)
    apply_recover_transform(s1)
    s2 = replay(view.records, 0)
    apply_recover_transform(s2)
    assert state_digest(s1) == state_digest(s2)


def test_single_gateway_recovery_books_and_order(tmp_path):
    path, clock, gw = _small_run(tmp_path)
    pre = (gw.admitted, gw.completed, dict(gw.admission.sheds))
    queued_before = [r.rid for r in gw.queue.pending()]
    inflight_before = sorted(gw.inflight)
    del gw
    gw2, info = recover_gateway(
        path, [SimServeBackend("b0", n_slots=2,
                               service_ns_per_cost=3 * MS, seed=2)],
        clock=clock)
    assert gw2.admitted == pre[0]
    assert gw2.completed == pre[1]
    assert gw2.admission.sheds == pre[2]
    assert gw2.admitted == gw2.completed + gw2.queue.depth() \
        + len(gw2.inflight)
    assert len(gw2.inflight) == 0
    assert set(info.requeued_inflight) == set(inflight_before)
    queued_after = [r.rid for r in gw2.queue.pending()]
    assert set(queued_after) == set(queued_before) | set(inflight_before)
    for _ in range(600):
        if not gw2.busy():
            break
        gw2.tick()
        clock.advance(1 * MS)
    assert gw2.admitted == gw2.completed
    r = gw2.submit("t1", None)
    assert r.admitted and "-r1-" in r.rid


def test_reopen_truncates_torn_tail_and_bumps_generation(tmp_path):
    path, _, _ = _small_run(tmp_path, ticks=6)
    clean = read_journal(path)
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")  # a crash's torn droppings
    j = GatewayJournal.reopen(path)
    assert j.generation == clean.generation + 1
    view = read_journal(path)
    assert view.torn_bytes == 0
    assert view.generation == clean.generation + 1
    assert len(view.records) == len(clean.records)
    j.close()


def _fed_member(P, clock, tick_ns):
    def member(name):
        salt = int(name[2:]) if name[2:].isdigit() else 99
        backends = [P.gw.SimServeBackend(f"{name}b{j}", n_slots=2,
                                         service_ns_per_cost=3 * tick_ns,
                                         seed=salt * 31 + j)
                    for j in range(2)]
        return P.gw.Gateway(backends, clock=clock, max_queued=256,
                            name=name)
    return member


def _fed_run_of(P, path, ticks: int = 80):
    """The reference test's journaled two-member federation, with a
    member death at tick 40, on package ``P``; the journal is abandoned
    (kill-9) at the end."""
    clock = P.clock.VirtualClock()
    tick_ns = 1 * MS
    member = _fed_member(P, clock, tick_ns)
    journal = P.gw.GatewayJournal.create(path)
    fed = P.gw.FederatedGateway([member("gw0"), member("gw1")],
                                clock=clock, renew_period_ns=4 * tick_ns,
                                lease_ttl_ns=6 * tick_ns, journal=journal)
    fed.register_tenant("ti", P.gw.quota_for("ti", "interactive", 256))
    fed.register_tenant("tb", P.gw.quota_for("tb", "batch", 256))
    for tick in range(ticks):
        fed.submit("ti", None, cost=1)
        if tick % 3 == 0:
            fed.submit("tb", None, cost=5)
        if tick == 40:
            fed.kill("gw1")
        fed.tick()
        clock.advance(tick_ns)
    audit, stats = fed.lease_audit(), fed.stats()
    journal.abandon()
    return clock, member, audit, stats


def test_federation_lease_audit_survives_kill9_exactly(tmp_path):
    path = str(tmp_path / "fed.jrnl")
    clock, member, audit_before, stats_before = _fed_run_of(PORT, path)
    fed2, info = port_recovery.recover_federation(
        path, member_factory=member, clock=clock,
        renew_period_ns=4 * MS, lease_ttl_ns=6 * MS)
    assert fed2.lease_audit() == audit_before
    st = fed2.stats()
    assert st["admitted"] == stats_before["admitted"]
    assert st["completed"] == stats_before["completed"]
    assert fed2.admitted == fed2.completed + fed2.queued() \
        + fed2.inflight_count()
    for _ in range(600):
        if not fed2.busy():
            break
        fed2.tick()
        clock.advance(MS)
    assert fed2.admitted == fed2.completed
    fed2.journal.close()


def test_cli_journal_dump_and_verify(tmp_path, capsys):
    path, _, _ = _small_run(tmp_path, ticks=6)
    assert main(["journal", "verify", path]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["warnings"] == [] and doc["records"] > 0
    assert main(["journal", "dump", path]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out)
    assert len(doc["entries"]) == doc["records"]
    ops = {e["op"] for e in doc["entries"]}
    assert {"ADMIT", "DISPATCH", "COMPLETE", "TENANT"} <= ops
    assert main(["journal", "dump", path]) == 0
    assert json.loads(capsys.readouterr().out) == doc
    # The reference's command prints the same bytes.
    assert ref_main(["journal", "dump", path]) == 0
    assert capsys.readouterr().out == out


def test_cli_journal_torn_tail_warns_exit_zero(tmp_path, capsys):
    path, _, _ = _small_run(tmp_path, ticks=6)
    with open(path, "ab") as f:
        f.write(os.urandom(5))
    assert main(["journal", "verify", path]) == 0
    out = capsys.readouterr()
    doc = json.loads(out.out)
    assert len(doc["warnings"]) == 1
    assert doc["torn_bytes"] == 5
    assert "WARNING" in out.err


def test_cli_journal_corrupt_exit_two(tmp_path, capsys):
    path, _, _ = _small_run(tmp_path, ticks=6)
    data = bytearray(open(path, "rb").read())
    data[60] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    assert main(["journal", "verify", path]) == 2
    assert "CORRUPT" in capsys.readouterr().err
    assert main(["journal", "dump", str(tmp_path / "nope.jrnl")]) == 2


# -- across the packages ------------------------------------------------


@pytest.mark.parametrize("ticks", [6, 24, 60])
def test_journal_files_are_byte_identical(tmp_path, ticks):
    files = [open(_small_run_of(P, str(tmp_path / f"{P.name}.jrnl"),
                                ticks)[0], "rb").read() for P in BOTH]
    assert files[0] == files[1]
    fed = []
    for P in BOTH:
        path = str(tmp_path / f"fed-{P.name}.jrnl")
        _fed_run_of(P, path, ticks=ticks + 20)
        fed.append(open(path, "rb").read())
    assert fed[0] == fed[1]


def _info(info) -> dict:
    d = dataclasses.asdict(info)
    return {k: sorted(v) if isinstance(v, set) else v for k, v in d.items()}


def _queues(gw) -> list:
    return [(r.rid, r.tenant, r.slo, r.cost, r.submit_ns, r.requeues)
            for r in gw.queue.pending()]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_recovers_the_others_gateway_journal(tmp_path, writer):
    """A journal either package wrote: both replay it to the same
    state digest, and both recover it to the same RecoveryInfo, queues,
    books and the same re-armed file."""
    W = {"ref": REF, "port": PORT}[writer]
    path = str(tmp_path / "gw.jrnl")
    _small_run_of(W, path, ticks=30)
    view = read_journal(path)
    assert dataclasses.asdict(view) == dataclasses.asdict(
        ref_journal.read_journal(path))
    digests = []
    for P in BOTH:
        st = P.recovery.replay(view.records, 0)
        P.recovery.apply_recover_transform(st)
        digests.append(P.recovery.state_digest(st))
    assert digests[0] == digests[1]
    got = []
    for P in BOTH:
        copy = str(tmp_path / f"{P.name}.jrnl")
        shutil.copy(path, copy)
        clock = P.clock.VirtualClock()
        gw, info = P.recovery.recover_gateway(
            copy, [P.gw.SimServeBackend("b0", n_slots=2,
                                        service_ns_per_cost=3 * MS,
                                        seed=2)], clock=clock)
        assert info.state_digest == digests[0]
        got.append((_info(info), _queues(gw), gw.admitted, gw.completed,
                    dict(gw.admission.sheds), gw.rid_generation,
                    open(copy, "rb").read()))
    assert got[0] == got[1]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_recovers_the_others_federation_journal(tmp_path,
                                                             writer):
    W = {"ref": REF, "port": PORT}[writer]
    path = str(tmp_path / "fed.jrnl")
    _, _, audit_before, _ = _fed_run_of(W, path)
    got = []
    for P in BOTH:
        copy = str(tmp_path / f"{P.name}.jrnl")
        shutil.copy(path, copy)
        clock = P.clock.VirtualClock()
        clock.advance(80 * MS)
        fed, info = P.recovery.recover_federation(
            copy, member_factory=_fed_member(P, clock, MS), clock=clock,
            renew_period_ns=4 * MS, lease_ttl_ns=6 * MS)
        assert fed.lease_audit() == audit_before
        queues = {n: _queues(m) for n, m in sorted(fed.members.items())}
        got.append((_info(info), queues, fed.stats(), fed.events,
                    open(copy, "rb").read()))
        fed.journal.close()
    assert got[0] == got[1]


def _count_fsyncs(monkeypatch, fn) -> int:
    n = [0]
    real = os.fsync

    def counting(fd):
        n[0] += 1
        return real(fd)

    monkeypatch.setattr(os, "fsync", counting)
    try:
        fn()
    finally:
        monkeypatch.setattr(os, "fsync", real)
    return n[0]


@pytest.mark.parametrize("fsync_every", [None, 1, 3])
def test_commit_fsyncs_at_the_same_commits(tmp_path, monkeypatch,
                                           fsync_every):
    """One seeded script, counted: the port's commit calls ``os.fsync``
    exactly as often as the reference's, at the registry default
    (``journal.fsync_every``) and at explicit cadences."""
    kw = {} if fsync_every is None else {"fsync_every": fsync_every}
    counts, commits = [], []
    for P in BOTH:
        path = str(tmp_path / f"{P.name}-{fsync_every}.jrnl")
        holder = {}

        def run(P=P, path=path):
            holder["gw"] = _small_run_of(P, path, 30, **kw)[2]

        counts.append(_count_fsyncs(monkeypatch, run))
        commits.append(holder["gw"]._journal.commits)
    assert counts[0] == counts[1]
    assert commits[0] == commits[1] > 0
    every = (port_journal.FSYNC_EVERY if fsync_every is None
             else fsync_every)
    assert counts[1] == (commits[1] // every if every else 0)


def test_torn_commit_fsyncs_the_same(monkeypatch):
    """The crash path (a ``journal.crash`` tear) fsyncs the torn prefix
    in both packages, once per fired kill."""
    counts = []
    for P in BOTH:
        counts.append(_count_fsyncs(monkeypatch, lambda P=P: (
            P.gw.run_federation_chaos(
                workload="mixed", seed=0, ticks=120,
                crash_plan=[{"record": 200, "cut": 9}]))))
    assert counts[0] == counts[1] >= 1
