"""Ownership leases over the shared cold directory (DESIGN.md §11).

Copy of ``repro/serving/fleet/cold_tier.py`` (framework-free).

The cold tier's *storage* contract — deterministic per-document file names
(``state_store.cold_path_for``) and atomic writes — lets any replica find
and read any document's spill. Leases add the *ownership* contract: at most
one replica serves a document at a time, so two replicas can never both
adopt (and then divergently edit) the same snapshot.

A lease is a sidecar file created with ``O_CREAT | O_EXCL`` — the classic
atomic-on-POSIX (and NFS-safe-enough for a CI fleet) mutual-exclusion
primitive; its payload names the owner for debuggability and for failover's
targeted ``break_lease``. Protocol:

* ``open`` / ``import`` on a replica acquires the document's lease first
  and refuses the document if another owner holds it;
* ``export`` (migration hand-off) and ``close`` release it;
* failover: the router — the single arbiter of replica death — breaks the
  dead owner's leases before reassigning its documents. Workers never break
  leases themselves.
"""
from __future__ import annotations

import json
import os

from repro_torch.serving.state_store import cold_path_for  # noqa: F401  (re-export)


class LeaseHeldError(RuntimeError):
    """Another replica holds the document's lease."""


def lease_path_for(cold_dir: str, doc_id: str) -> str:
    return cold_path_for(cold_dir, doc_id) + ".lease"


def acquire_lease(cold_dir: str, doc_id: str, owner: str) -> None:
    """Take ownership of ``doc_id``. Idempotent for the same owner (a
    re-acquire after e.g. a retried import); raises ``LeaseHeldError`` when
    someone else holds it."""
    os.makedirs(cold_dir, exist_ok=True)
    path = lease_path_for(cold_dir, doc_id)
    payload = json.dumps({"owner": owner, "doc_id": doc_id}).encode()
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        holder = lease_owner(cold_dir, doc_id)
        if holder == owner:
            return
        raise LeaseHeldError(
            f"document {doc_id!r} is leased to {holder!r}") from None
    try:
        os.write(fd, payload)
    finally:
        os.close(fd)


def lease_owner(cold_dir: str, doc_id: str) -> str | None:
    """The current lease holder, or None. A vanished-mid-read lease (the
    owner released concurrently) reads as None."""
    try:
        with open(lease_path_for(cold_dir, doc_id)) as f:
            return json.load(f).get("owner")
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def release_lease(cold_dir: str, doc_id: str, owner: str) -> None:
    """Give up ownership. Raises if someone ELSE holds the lease (releasing
    a peer's lease is always a bug); a missing lease is a no-op (release
    after a failover break)."""
    holder = lease_owner(cold_dir, doc_id)
    if holder is None:
        return
    if holder != owner:
        raise LeaseHeldError(
            f"cannot release {doc_id!r}: leased to {holder!r}, not {owner!r}")
    try:
        os.remove(lease_path_for(cold_dir, doc_id))
    except FileNotFoundError:
        pass


def break_lease(cold_dir: str, doc_id: str) -> None:
    """Forcibly clear a lease regardless of owner — the router's failover
    prerogative, used only for documents whose owning replica is dead."""
    try:
        os.remove(lease_path_for(cold_dir, doc_id))
    except FileNotFoundError:
        pass
