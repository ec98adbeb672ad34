"""Checkpoint/restart in the JAX package's on-disk format.

Counterpart of ``repro.checkpoint.ckpt`` over the port's trees: nested
dicts, lists, tuples and dataclasses (the optimiser's ``AdamWState``) of
torch tensors and numpy arrays. One directory per step holds one ``.npy``
per leaf (its raw bytes as a ``uint8`` vector) and ``manifest.json`` with
each leaf's shape, dtype string, the crc32 of its file as written and the
first 16 hex digits of the payload's sha256, plus the caller's metadata.
Leaves are named by their tree path exactly as the JAX package's
``_leaf_key`` names them (``params.blocks.0_attn.attn.wq``, ``opt].step``,
``opt].mu[embed``), so a directory written by either package loads in the
other, bit for bit.

bf16 needs no ``ml_dtypes``: a ``torch.bfloat16`` leaf is written from its
``uint16`` bits under the dtype string ``"bfloat16"``, and such a leaf is
read back as a ``torch.bfloat16`` tensor, or as its ``uint16`` bits where
the caller's leaf is a numpy array.

Writes go to ``step_XXXXXXXX.tmp.<pid>`` and are renamed, so a crash
mid-write never leaves a torn step behind; a resume skips a step that
fails verification and falls back to the newest intact one.
:class:`CheckpointManager` adds an async writer thread, retention and
resume discovery. The port's tensors are mutable (a trainer updates its
state in place), so :meth:`CheckpointManager.save` copies every leaf to
the host before it returns.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import queue
import shutil
import threading
import time
import warnings
import zlib

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "available_steps",
           "CheckpointManager"]

_MANIFEST = "manifest.json"


# --------------------------------------------------------------------- #
# tree paths (jax.tree_util's order and key strings)
# --------------------------------------------------------------------- #
def _children(node):
    """``(key string, child)`` pairs of an inner node in
    ``jax.tree_util`` order, or None for a leaf: dict keys sorted
    (``['key']``), sequence items by index (``[i]``), dataclass fields in
    declaration order (``.name``, as a NamedTuple's fields)."""
    if isinstance(node, dict):
        return [(f"[{key!r}]", node[key]) for key in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _paths(tree, prefix=""):
    """``(keystr, leaf)`` pairs in flatten order (None is an empty
    subtree, as in JAX)."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from _paths(child, prefix + key)


def _leaf_key(keystr: str) -> str:
    return keystr.replace("/", "_").strip("[]'\"()") \
        .replace("'][", ".").replace("][", ".").replace("'", "")


def _flatten(tree) -> dict:
    return {(_leaf_key(p) or f"leaf{i}"): v
            for i, (p, v) in enumerate(_paths(tree))}


def _unflatten(tree, values):
    """``tree`` with its leaves replaced, in flatten order, by the items
    of the iterator ``values``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {key: _unflatten(tree[key], values) for key in sorted(tree)}
        return {key: new[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _unflatten(getattr(tree, f.name),
                                                values)
                             for f in dataclasses.fields(tree)})
    return next(values)


# --------------------------------------------------------------------- #
# leaves <-> bytes
# --------------------------------------------------------------------- #
def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a C-contiguous host array of its bytes and its dtype
    string (``"bfloat16"`` for bf16 tensors, carried as ``uint16``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.ascontiguousarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(tree):
    """Every tensor and array leaf copied to the host, synchronously: an
    async write must see the values at save time, not a later step's."""
    def copy(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True)
        if isinstance(leaf, np.ndarray):
            return leaf.copy()
        return leaf
    flat = _flatten(tree)
    return _unflatten(tree, iter([copy(v) for v in flat.values()]))


class _CrcWriter:
    """A write-only file that keeps the crc32 of what went through it."""

    def __init__(self, fh):
        self.fh, self.crc = fh, 0

    def write(self, b) -> int:
        self.crc = zlib.crc32(b, self.crc)
        return self.fh.write(b)


def _npy_payload(buf: bytearray) -> np.ndarray:
    """The 1-D ``uint8`` payload of an ``.npy`` file held in ``buf``
    (a writable view of it; raises ``ValueError`` on a malformed file)."""
    f = io.BytesIO(buf)
    major, _ = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if major == 1
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(f)
    if dtype != np.uint8 or len(shape) != 1 or fortran:
        raise ValueError(f"not a uint8 vector: {dtype} {shape}")
    return np.frombuffer(buf, np.uint8, count=shape[0], offset=f.tell())


def _as_leaf(raw: np.ndarray, ent: dict, like):
    """Raw payload bytes -> a leaf shaped like ``like``: a tensor on its
    device where ``like`` is a tensor, else a numpy array (bf16 as its
    ``uint16`` bits)."""
    bf16 = ent["dtype"] == "bfloat16"
    arr = raw.view(np.uint16 if bf16 else np.dtype(ent["dtype"]))
    shape = tuple(getattr(like, "shape", ent["shape"]))
    arr = arr.reshape(shape)
    if not isinstance(like, torch.Tensor):
        return arr
    t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if bf16
         else torch.from_numpy(arr))
    return t.to(like.device)


def _process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, else 0."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


# --------------------------------------------------------------------- #
# one step on disk
# --------------------------------------------------------------------- #
def save_checkpoint(path: str, tree, *, step: int,
                    metadata: dict | None = None) -> str:
    """Atomic synchronous save. Returns the final directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    man = {"step": step, "metadata": metadata or {}, "leaves": {},
           "process": _process_index()}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _host_array(leaf)
        payload = arr.reshape(-1).view(np.uint8)
        fn = f"{key}.npy"
        # the crc32 covers the FILE as written (npy header included), so
        # corruption anywhere in it is caught at resume; sha256 is the
        # payload's
        with open(os.path.join(tmp, fn), "wb") as fh:
            w = _CrcWriter(fh)
            np.save(w, payload)
        man["leaves"][key] = {
            "file": fn, "shape": list(arr.shape), "dtype": dtype,
            "sha256": hashlib.sha256(payload).hexdigest()[:16],
            "crc32": w.crc,
        }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(man, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _load_step(path: str, step: int, keys, verify: bool):
    """Load and verify one step directory: ``(raw payloads, entries,
    manifest)``. Raises ``IOError`` on any integrity failure (crc or hash
    mismatch, an unreadable or missing leaf file)."""
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        man = json.load(f)
    raws, ents = [], []
    for key in keys:
        ent = man["leaves"][key]
        fp = os.path.join(d, ent["file"])
        with open(fp, "rb") as fh:
            buf = bytearray(os.fstat(fh.fileno()).st_size)
            fh.readinto(buf)
        if verify and "crc32" in ent and zlib.crc32(buf) != ent["crc32"]:
            raise IOError(f"checkpoint leaf {key} crc32 mismatch ({fp})")
        try:
            raw = _npy_payload(buf)
        except (OSError, ValueError) as e:
            raise IOError(f"checkpoint leaf {key} unreadable: {e}")
        if verify and \
                hashlib.sha256(raw).hexdigest()[:16] != ent["sha256"]:
            raise IOError(f"checkpoint leaf {key} hash mismatch")
        raws.append(raw)
        ents.append(ent)
    return raws, ents, man


def load_checkpoint(path: str, tree_like, *, step: int | None = None,
                    verify: bool = True):
    """Restore into the structure of ``tree_like``; returns ``(tree,
    metadata)``, the metadata with the step under ``"step"``.

    ``step=None`` takes the newest INTACT step: a step that fails
    verification is skipped with a ``RuntimeWarning`` and the next-newest
    one is tried. An explicit ``step`` raises on corruption."""
    flat = _flatten(tree_like)
    keys = list(flat)
    if step is not None:
        raws, ents, man = _load_step(path, step, keys, verify)
    else:
        steps = available_steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        raws = man = None
        for s in reversed(steps):
            try:
                raws, ents, man = _load_step(path, s, keys, verify)
                break
            except (OSError, KeyError, ValueError) as e:
                warnings.warn(
                    f"checkpoint step_{s:08d} under {path} failed "
                    f"verification ({e}); falling back to the newest "
                    f"intact step. Delete that directory to stop "
                    f"resuming past it.", RuntimeWarning, stacklevel=2)
        if raws is None:
            raise IOError(
                f"no intact checkpoint under {path}: every step in "
                f"{steps} failed verification")
    leaves = [_as_leaf(r, e, like)
              for r, e, like in zip(raws, ents, flat.values())]
    return (_unflatten(tree_like, iter(leaves)),
            man["metadata"] | {"step": man["step"]})


def _is_tmp_dir(name: str) -> bool:
    """In-progress or orphaned write dirs: ``step_XXXXXXXX.tmp.<pid>``."""
    return name.startswith("step_") and ".tmp." in name


def available_steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for n in os.listdir(path):
        if n.startswith("step_") and not _is_tmp_dir(n):
            try:
                out.append(int(n.split("_")[1]))
            except (IndexError, ValueError):
                pass
    return sorted(out)


# --------------------------------------------------------------------- #
# async writes and retention
# --------------------------------------------------------------------- #
class CheckpointManager:
    """Async checkpointing with retention: I/O overlaps the next steps.

    :meth:`save` copies the tree to the host and enqueues it; a worker
    thread writes it. ``keep`` bounds the retained steps (the latest is
    always kept). :meth:`wait` drains the queue and re-raises a writer
    error. ``stats`` records, per save, its step, payload bytes, the
    seconds of the host copy on the caller's thread (``copy_s``) and of
    the write on the worker's (``write_s``).
    """

    #: a foreign step_*.tmp.<pid> dir younger than this is presumed to
    #: be another writer mid-save and is never reaped
    STALE_TMP_SECS = 3600.0

    def __init__(self, path: str, *, keep: int = 3, async_: bool = True):
        self.path = path
        self.keep = keep
        self.async_ = async_
        self.stats: list[dict] = []
        self._q: queue.Queue = queue.Queue()
        self._err: Exception | None = None
        self._worker = None
        if async_:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _write(self, tree, step, meta, rec) -> None:
        t0 = time.perf_counter()
        save_checkpoint(self.path, tree, step=step, metadata=meta)
        rec["write_s"] = time.perf_counter() - t0
        self._gc()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(*item)
            except Exception as e:   # surfaced on the next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = available_steps(self.path)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)
        # crashed saves leave step_*.tmp.<pid> dirs behind: reap the
        # stale ones, never our own pid, a live local writer's or one
        # younger than STALE_TMP_SECS (pids do not compare across
        # hosts, so for another host's writer age is the only signal)
        if not os.path.isdir(self.path):
            return
        now = time.time()
        for n in os.listdir(self.path):
            if not _is_tmp_dir(n):
                continue
            pid = n.rsplit(".", 1)[-1]
            if not pid.isdigit() or int(pid) == os.getpid():
                continue
            path = os.path.join(self.path, n)
            try:
                if now - os.path.getmtime(path) < self.STALE_TMP_SECS:
                    continue              # possibly mid-write elsewhere
                os.kill(int(pid), 0)      # raises if no such local pid
                continue                  # live local writer: keep
            except ProcessLookupError:
                pass                      # dead locally AND stale: reap
            except (PermissionError, OSError):
                continue                  # exists but not ours: keep
            shutil.rmtree(path, ignore_errors=True)

    def save(self, tree, *, step: int, metadata: dict | None = None):
        if self._err:
            raise self._err
        t0 = time.perf_counter()
        host_tree = _host_copy(tree)
        rec = {"step": step, "copy_s": time.perf_counter() - t0,
               "bytes": sum(_host_array(v)[0].nbytes
                            for v in _flatten(host_tree).values())}
        self.stats.append(rec)
        if self.async_:
            self._q.put((host_tree, step, metadata, rec))
        else:
            self._write(host_tree, step, metadata, rec)

    def wait(self):
        if self.async_:
            self._q.join()
        if self._err:
            raise self._err

    def latest_step(self) -> int | None:
        steps = available_steps(self.path)
        return steps[-1] if steps else None

    def restore(self, tree_like, *, step: int | None = None):
        return load_checkpoint(self.path, tree_like, step=step)

    def close(self):
        if self.async_ and self._worker:
            self._q.put(None)
            self._worker.join(timeout=30)
