"""Full training-state checkpoints in the JAX package's file format, jax-free.

Counterpart of :mod:`ucod_dpl_tpu.engine.checkpoint` (the reference's
``save_mode='all'`` state, ``runner.py:165-185``, and the ``--resume`` it
parses but never reads).  A state is a tree of numpy arrays (nested dicts
and lists) in the JAX package's layout, what
:func:`~ucod_dpl_tpu_torch.models.convert.train_state_to_jax` and
:func:`~ucod_dpl_tpu_torch.models.convert.lora_state_to_jax` give, so one
``.npz`` holds the same key paths (``decoder/decoupling_w``,
``opt_state/0/mu/...``, ``ema_step``), dtypes and shapes as the JAX
package's, and either package resumes the other's ``state_epochN`` and
``state_preempt`` files.

The JAX package's ``orbax`` backend is a JAX library's format (sharded
saves, each process writing the shards it owns) and stays refused: asking
for it, or loading an ``.orbax`` directory, raises ``NotImplementedError``.
Under the port's data parallelism the state is replicated, so process 0
writes the ``.npz`` (``engine/train_loop.py``) and every rank reads it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np

_META_KEY = "__meta_json__"
_ORBAX = ("the orbax checkpoint backend is a JAX library's format, which the PyTorch port does not read or write; "
          "use backend='npz' (data-parallel runs write it from process 0)")


def _map_with_paths(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists, where ``path`` is
    the JAX package's key path (keys and indices joined by ``/``)."""
    if isinstance(tree, Mapping):
        return {k: _map_with_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def flatten_with_paths(tree: Any) -> Dict[str, np.ndarray]:
    """``{key path: array}`` of a state tree (the JAX ``_flatten_with_paths``)."""
    flat: Dict[str, np.ndarray] = {}

    def put(path, leaf):
        flat[path] = np.asarray(leaf)

    _map_with_paths(put, tree)
    return flat


def _write_json_atomic(path: str, obj: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def save_train_state(path: str, state: Any, metadata: Dict[str, Any], backend: str = "npz") -> None:
    """Write ``path.npz`` (the state with ``metadata`` embedded as JSON under
    ``__meta_json__``) and the sidecar ``path.json``.

    The preemption path overwrites one fixed path on every signal and a
    SIGKILL can land mid-save, so the archive goes to a temp file and is
    committed by one ``os.replace`` with its metadata inside; the sidecar
    follows as a readable copy, and the loader prefers the embedded one.  A
    stale ``path.orbax`` of the other backend is removed."""
    if backend == "orbax":
        raise NotImplementedError(_ORBAX)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = flatten_with_paths(state)
    flat[_META_KEY] = np.frombuffer(json.dumps(metadata).encode(), dtype=np.uint8)
    tmp = f"{path}.npz.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path + ".npz")
    if os.path.isdir(path + ".orbax"):
        shutil.rmtree(path + ".orbax")
    _write_json_atomic(path + ".json", metadata)


def load_train_state(path: str, template: Any) -> Tuple[Any, Dict[str, Any]]:
    """(state, metadata) from ``path.npz``: a tree shaped like ``template``
    whose leaves take the template's dtypes and shapes.  Raises ValueError
    on keys the file lacks; the metadata is the embedded copy, or the
    sidecar of a file written before it was embedded.  Where both backends'
    files exist (a crash between a save and the removal of the other), the
    newer one is the state, as in the JAX package."""
    if os.path.isdir(path + ".orbax") and not (
        os.path.exists(path + ".npz") and os.path.getmtime(path + ".npz") >= os.path.getmtime(path + ".orbax")
    ):
        raise NotImplementedError(f"{path}.orbax: {_ORBAX}")
    with np.load(path + ".npz") as data:
        flat_template = flatten_with_paths(template)
        missing = set(flat_template) - set(data.files)
        if missing:
            raise ValueError(f"Checkpoint {path} missing keys: {sorted(missing)[:5]}...")
        state = _map_with_paths(
            lambda key, leaf: np.asarray(data[key], dtype=np.asarray(leaf).dtype).reshape(np.shape(leaf)), template)
        meta_raw = bytes(data[_META_KEY]) if _META_KEY in data.files else None
    if meta_raw is not None:
        return state, json.loads(meta_raw.rstrip(b"\x00").decode())
    with open(path + ".json") as f:
        return state, json.load(f)
