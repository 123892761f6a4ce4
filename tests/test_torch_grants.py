"""``pbs_tpu_torch.runtime.grants`` against ``pbs_tpu.runtime.grants``.

Every grant case of ``tests/test_grants_xsm.py`` is written as a
function of a package namespace: it runs on both packages, makes the
reference test's own assertions on each, and the two runs' observables
(entries, refcounts, error types and words, region bytes) must be equal.
Then across packages: a grant made by one package's table is mapped by
the other's ``map_grant`` from its wire form, in a second process.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import types

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity tests need the JAX reference")


def _ns(root: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        root=root, rt=importlib.import_module(f"{root}.runtime"),
        grants=importlib.import_module(f"{root}.runtime.grants"))


REF = _ns("pbs_tpu")
PORT = _ns("pbs_tpu_torch")
PACKAGES = [REF, PORT]


def _raises(exc, fn) -> str:
    with pytest.raises(exc) as info:
        fn()
    return f"{type(info.value).__name__}: {info.value}"


def _region(P):
    return P.rt.SharedRegion(size=4096, create=True)


def _close(region) -> None:
    region.close()
    region.unlink()


def c_map_unmap_refcount(P):
    region = _region(P)
    try:
        gt = P.rt.GrantTable("domA")
        ref = gt.grant_access("domB", region, offset=100, length=256)
        with gt.map_ref(ref, "domB", write=True) as m:
            m.data[:4] = [1, 2, 3, 4]
            assert gt.entry(ref).use_count == 1
            busy = _raises(P.rt.GrantBusy, lambda: gt.end_access(ref))
        assert gt.entry(ref).use_count == 0
        got = list(region.view(100, 4))
        assert got == [1, 2, 3, 4]
        gt.end_access(ref)
        revoked = _raises(P.rt.GrantError, lambda: gt.map_ref(ref, "domB"))
        assert "revoked" in revoked
        e = gt.entry(ref)
        return [busy, revoked, got, e.describe()["offset"], e.length,
                e.revoked, e.use_count, len(gt.active())]
    finally:
        _close(region)


def c_enforces_grantee_and_mode(P):
    region = _region(P)
    try:
        gt = P.rt.GrantTable("domA")
        ref = gt.grant_access("domB", region, readonly=True)
        who = _raises(P.rt.GrantDenied, lambda: gt.map_ref(ref, "domC"))
        mode = _raises(P.rt.GrantDenied,
                       lambda: gt.map_ref(ref, "domB", write=True))
        assert "not" in who and "read-only" in mode
        m = gt.map_ref(ref, "domB")
        writeable = bool(m.data.flags.writeable)
        assert not writeable
        m.unmap()
        return [who, mode, writeable, gt.entry(ref).use_count]
    finally:
        _close(region)


def c_range_validation(P):
    region = _region(P)
    try:
        gt = P.rt.GrantTable("domA")
        out = _raises(P.rt.GrantError, lambda: gt.grant_access(
            "domB", region, offset=4000, length=200))
        assert "outside" in out
        return out
    finally:
        _close(region)


def c_transfer_moves_ownership(P):
    region = _region(P)
    try:
        gt = P.rt.GrantTable("domA")
        ref = gt.grant_access("domB", region)
        e = gt.transfer(ref, "domB")
        assert e.transferred_to == "domB"
        bad = _raises(P.rt.GrantError, lambda: gt.entry(ref))
        assert "bad grant ref" in bad
        return [e.transferred_to, e.revoked, bad]
    finally:
        _close(region)


def c_force_end_access_while_mapped(P):
    region = _region(P)
    try:
        gt = P.rt.GrantTable("domA")
        ref = gt.grant_access("domB", region)
        m = gt.map_ref(ref, "domB", write=True)
        gt.end_access(ref, force=True)
        m.data[0] = 7
        m.unmap()
        revoked = _raises(P.rt.GrantError, lambda: gt.map_ref(ref, "domB"))
        assert "revoked" in revoked
        return [revoked, int(region.view(0, 1)[0])]
    finally:
        _close(region)


def c_map_failure_does_not_wedge_refcount(P):
    region = _region(P)
    try:
        gt = P.rt.GrantTable("domA")
        ref = gt.grant_access("domB", region)
        e = gt.entry(ref)
        real_segment = e.segment
        e.segment = "pbst-definitely-missing-segment"
        with pytest.raises(FileNotFoundError):
            gt.map_ref(ref, "domB")
        e.segment = real_segment
        assert gt.entry(ref).use_count == 0
        gt.end_access(ref)  # must not raise GrantBusy
        return gt.entry(ref).revoked
    finally:
        _close(region)


def c_wire_form_refuses_write_on_readonly(P):
    region = _region(P)
    try:
        gt = P.rt.GrantTable("domA")
        ref = gt.grant_access("domB", region, offset=8, length=16,
                              readonly=True)
        desc = gt.entry(ref).describe()
        denied = _raises(P.rt.GrantDenied,
                         lambda: P.rt.map_grant(desc, write=True))
        r, view = P.rt.map_grant(desc)
        shape = view.shape
        del view
        r.close()
        return [sorted(desc), desc["offset"], desc["length"], denied,
                list(shape)]
    finally:
        _close(region)


CASES = [c_map_unmap_refcount, c_enforces_grantee_and_mode,
         c_range_validation, c_transfer_moves_ownership,
         c_force_end_access_while_mapped,
         c_map_failure_does_not_wedge_refcount,
         c_wire_form_refuses_write_on_readonly]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_grant_case_twin(case):
    got = [repr(case(P)) for P in PACKAGES]
    assert got[1] == got[0]


def test_grant_names_are_the_reference_s():
    names = ("GrantBusy", "GrantDenied", "GrantError", "GrantMapping",
             "GrantTable", "SharedRegion", "map_grant")
    for n in names:
        assert n in PORT.rt.__all__ and n in REF.rt.__all__
    assert issubclass(PORT.rt.GrantBusy, PORT.rt.GrantError)
    assert issubclass(PORT.rt.GrantDenied, PORT.rt.GrantError)
    assert PORT.grants.GRANT_INVALID == REF.grants.GRANT_INVALID


def _child_fill(root: str, desc: dict, q) -> None:
    rt = importlib.import_module(f"{root}.runtime.grants")
    region, view = rt.map_grant(desc, write=True)
    try:
        view[:] = np.arange(len(view), dtype=np.uint8)
        q.put("done")
    finally:
        del view
        region.close()


@pytest.mark.parametrize("granter,mapper", [("pbs_tpu_torch", "pbs_tpu"),
                                            ("pbs_tpu", "pbs_tpu_torch")])
def test_grant_cross_process_zero_copy_across_packages(granter, mapper):
    """The blkfront/blkback pattern across packages: one package's table
    grants, a second process maps the wire form with the other's
    ``map_grant`` and writes; the granter sees the bytes."""
    G = _ns(granter)
    region = G.rt.SharedRegion(size=4096, create=True)
    try:
        gt = G.rt.GrantTable("domA")
        ref = gt.grant_access("peer", region, offset=64, length=128)
        desc = gt.entry(ref).describe()
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        p = ctx.Process(target=_child_fill, args=(mapper, desc, q))
        p.start()
        assert q.get(timeout=60) == "done"
        p.join(timeout=30)
        assert list(region.view(64, 8)) == [0, 1, 2, 3, 4, 5, 6, 7]
        assert list(region.view(64 + 127, 1)) == [127]
    finally:
        _close(region)
