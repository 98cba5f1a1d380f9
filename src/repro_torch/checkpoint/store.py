"""Checkpoints — the port of ``repro/checkpoint/store.py``: NPZ pytree
files (parameters, train states) and serving-document snapshots.

Pytrees are flattened to ``path -> ndarray`` npz entries, the path joined
from ``common.pytree.path_names`` (``params/stages/0/0/mixer/vq/codebook``),
and restored into the structure of a ``like`` tree, as the reference does.
Key strings, dtypes and shapes are the reference's, so a parameter or
train-state file written by either package reads in the other.

A serving document's durable incremental state is more than its arrays: the
position allocator's id sequence and the suggestion watermarks travel with
the ``JitState``, so a restore (same process or a later one) reproduces the
document exactly — rehydration is a pure re-upload, never a recompute.
Everything lives in ONE npz (no sidecar): state leaves under
``state/<field>``, the allocator snapshot under ``allocator/ids``, the
server's host mirrors and slot layout under ``mirror/<name>`` (full serving
snapshots only), and the scalar metadata as a JSON string array (unicode
arrays load without pickle). Leaf names, dtypes and shapes are the
reference's here too.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from repro_torch.common.pytree import path_names, tree_flatten_with_path, tree_map_with_path

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


def _key(path) -> str:
    return "/".join(path_names(path))


def save_pytree(path: str, tree, metadata: Optional[dict] = None) -> None:
    """Every leaf of ``tree`` (tensors on any device, arrays, scalars) as an
    npz entry under its path; ``metadata`` in a ``.meta.json`` sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{_key(p): _leaf(leaf) for p, leaf in tree_flatten_with_path(tree)})
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def restore_pytree(path: str, like):
    """Restore into the structure of ``like``: each leaf keeps ``like``'s
    dtype and device (a tensor stays a tensor there, else an array).
    Raises ``KeyError`` on a missing entry, ``ValueError`` on a shape that
    differs from ``like``'s."""
    import torch

    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def load(p, leaf):
        key = _key(p)
        if key not in data:
            raise KeyError(f"checkpoint missing array {key!r}")
        arr = data[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != expected "
                             f"{tuple(np.shape(leaf))}")
        if isinstance(leaf, torch.Tensor):
            return torch.as_tensor(np.array(arr)).to(dtype=leaf.dtype, device=leaf.device)
        return arr.astype(np.asarray(leaf).dtype)

    return tree_map_with_path(load, like)


def save_train_state(path: str, state, step: Optional[int] = None) -> None:
    save_pytree(path, state, metadata={"step": step})


def restore_train_state(path: str, like):
    return restore_pytree(path, like)


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
