"""Serving-document checkpoints — the document half of
``repro/checkpoint/store.py`` (framework-free: NumPy and JSON only).

A serving document's durable incremental state is more than its arrays: the
position allocator's id sequence and the suggestion watermarks travel with
the ``JitState``, so a restore (same process or a later one) reproduces the
document exactly — rehydration is a pure re-upload, never a recompute.
Everything lives in ONE npz (no sidecar): state leaves under
``state/<field>``, the allocator snapshot under ``allocator/ids``, the
server's host mirrors and slot layout under ``mirror/<name>`` (full serving
snapshots only), and the scalar metadata as a JSON string array (unicode
arrays load without pickle). Leaf names, dtypes and shapes are the
reference's, so a file written by either package reads in the other.

The reference's pytree and train-state half (``save_pytree`` /
``restore_pytree``) walks jax tree paths; it lands with training.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_DOC_META_KEY = "doc_meta/json"
# Attention reduces over the slot axis, so a permutation of slots changes
# float summation order: bit-exact migration ships the slot layout and the
# free-list ORDER verbatim instead of re-deriving them on import.
_MIRROR_FIELDS = ("tokens", "valid", "positions", "slots", "free")


def _leaf(x) -> np.ndarray:
    """A state leaf (host array or tensor on any device) as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def atomic_savez(path: str, arrays: dict) -> None:
    """``np.savez`` with crash-safe visibility: write to a temp file in the
    SAME directory, fsync, then ``os.replace`` into place. A crash mid-write
    leaves at most an orphan ``*.tmp`` that this call removes — the
    destination either does not exist or holds a complete npz, so a reader
    (rehydrate, migration import) never observes a truncated archive."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        # np.savez appends ".npz" to a bare str path; an open file object
        # keeps the temp name exactly as constructed
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _state_arrays(state, allocator_ids) -> dict:
    # imported here: the serving package imports this module (its store's
    # cold tier), so a top-level import would be circular
    from repro_torch.serving.jit_engine import JitState

    if not isinstance(state, JitState):
        raise TypeError(f"expected a JitState, got {type(state).__name__}")
    arrays = {f"state/{name}": _leaf(leaf)
              for name, leaf in zip(JitState._fields, state)}
    arrays["allocator/ids"] = np.asarray(allocator_ids, np.int32)
    return arrays


def _load_state(data, what: str):
    from repro_torch.serving.jit_engine import JitState

    missing = [f for f in JitState._fields if f"state/{f}" not in data]
    if missing:
        raise KeyError(f"{what} missing state fields {missing}")
    return JitState(*(data[f"state/{f}"] for f in JitState._fields))


def _load_meta(data) -> dict:
    return json.loads(str(data[_DOC_META_KEY])) if _DOC_META_KEY in data else {}


def save_document_state(path: str, state, *, allocator_ids,
                        invalid_from: Optional[int] = None,
                        touched_from: Optional[int] = None,
                        extra: Optional[dict] = None) -> None:
    """Serialize a serving ``JitState`` (device or host leaves) plus the
    allocator's position-id snapshot and the suggestion watermarks.
    ``extra`` merges additional JSON-serializable metadata (e.g. a doc id)."""
    arrays = _state_arrays(state, allocator_ids)
    meta = dict(extra or {})
    meta["invalid_from"] = invalid_from
    meta["touched_from"] = touched_from
    arrays[_DOC_META_KEY] = np.asarray(json.dumps(meta))
    atomic_savez(path, arrays)


def restore_document_state(path: str):
    """Inverse of ``save_document_state``: ``(state, allocator_ids, meta)``
    with numpy leaves (upload with ``serving.jit_engine.state_from_host``).
    Bit-exact: every leaf round-trips through npz unchanged."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    state = _load_state(data, "document checkpoint")
    if "allocator/ids" not in data:
        raise KeyError("document checkpoint missing allocator/ids")
    return state, data["allocator/ids"], _load_meta(data)


def save_serving_document(path: str, state, *, allocator_ids,
                          mirrors: dict, meta: dict) -> None:
    """Atomic one-file snapshot of a live serving document: the ``JitState``
    and allocator ids (as in ``save_document_state``), the server's host
    mirrors and slot layout under ``mirror/<name>``, and a JSON metadata
    blob (row_capacity, watermarks, pos_pool, consistency flag...) — the
    unit of cross-replica migration."""
    missing = [m for m in _MIRROR_FIELDS if m not in mirrors]
    if missing:
        raise KeyError(f"serving snapshot missing mirrors {missing}")
    arrays = _state_arrays(state, allocator_ids)
    for name in _MIRROR_FIELDS:
        arrays[f"mirror/{name}"] = np.asarray(mirrors[name])
    arrays[_DOC_META_KEY] = np.asarray(json.dumps(meta))
    atomic_savez(path, arrays)


def restore_serving_document(path: str):
    """Inverse of ``save_serving_document``: ``(state, allocator_ids,
    mirrors, meta)`` with numpy leaves. Raises ``KeyError`` on a bare
    ``save_document_state`` file (no ``mirror/*`` entries)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    state = _load_state(data, "serving snapshot")
    mirrors = {}
    for name in _MIRROR_FIELDS:
        key = f"mirror/{name}"
        if key not in data:
            raise KeyError(f"serving snapshot missing {key} "
                           "(plain document checkpoint? use restore_document_state)")
        mirrors[name] = data[key]
    return state, data["allocator/ids"], mirrors, _load_meta(data)
