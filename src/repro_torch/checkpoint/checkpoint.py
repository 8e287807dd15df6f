"""Tree checkpoints: one host ``.npz`` per step, written atomically.

The format is ``repro.checkpoint``'s: ``ckpt_{step:08d}.npz`` in the
directory, one array per leaf under its path, the parts joined by ``/``
as ``repro.checkpoint._flatten_with_paths`` joins them (a dict key, a
tuple index, ``.name`` for a dataclass field, so a whole
:class:`repro_torch.api.build.ProgramState` keeps its params under
``.inner/.params/``), and ``treedef.json``. Three things are the port's:

* every file holds the key :data:`PORT_KEY`: its trees are in the port's
  layouts (per-layer transformer blocks, OIHW convolutions), which is
  how a reader tells them from the reference's files;
* a leaf whose first axis is a broadcast (stride 0 -- a client half
  repeated over its slots by ``stack_client_params``) is stored once,
  its slot count under ``key + SLOTS_SUFFIX``, and restored as the same
  broadcast view, so a restored state is the saved one in values and
  in layout;
* a dense leaf whose rows (along the first axis, each of at least 64
  KiB) repeat bit for bit is stored as its distinct rows, each row's
  index into them under ``key + ROWS_SUFFIX``, and restored dense: an
  async state's snapshots are copies of a few global versions and its
  never-arrived clients' moment rows are all zero (16 snapshots and
  moments of qwen1.5-0.5b are 23 GB);
* a bfloat16 leaf (numpy has none) is stored as its int16 bits;
* a numpy leaf (the async runtime's host schedule: finish times,
  versions, retries, the clock) is restored as numpy of its own dtype.

Crash safety as in the reference: every file goes to a temp path in the
same directory, is fsync'd and atomically renamed over the target
(``os.replace``), then the directory is fsync'd. ``restore`` treats an
unreadable newest checkpoint as absent and falls back to the next older
step, unless the step was pinned.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

# Failure modes of np.load on a torn/corrupt .npz: truncated zip central
# directory (BadZipFile), short reads / missing members (OSError,
# KeyError), and mangled array headers (ValueError).
CORRUPT_ERRORS = (zipfile.BadZipFile, OSError, KeyError, ValueError,
                  EOFError)
PORT_KEY = "repro_torch_format"
SLOTS_SUFFIX = "@slots"
ROWS_SUFFIX = "@rows"
_MIN_ROW_BYTES = 1 << 16
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _children(tree):
    """(path part, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [("." + f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in leaf order; ``None`` and empty nodes hold none."""
    kids = _children(tree)
    if kids is None:
        return {} if tree is None else {prefix: tree}
    out = {}
    for part, child in kids:
        out.update(flatten_with_paths(
            child, f"{prefix}/{part}" if prefix else part))
    return out


def _rebuild(tree, values, prefix: str = ""):
    """``tree``'s structure with the leaf at each path from ``values``."""
    kids = _children(tree)
    if kids is None:
        return tree if tree is None else values[prefix]
    new = [_rebuild(child, values, f"{prefix}/{part}" if prefix else part)
           for part, child in kids]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), new))
    if isinstance(tree, (tuple, list)):
        return type(tree)(new)
    return dataclasses.replace(tree, **{
        f.name: v for f, v in zip(dataclasses.fields(tree), new)})


def _repeated_rows(t):
    """(the distinct rows, each row's index into them) of a dense (K, ...)
    tensor whose rows of >= 64 KiB repeat bit for bit, or None. A row's
    word sum picks the candidates, ``torch.equal`` on the words decides."""
    if (t.dim() < 2 or t.shape[0] < 2 or t.element_size() not in _WORDS
            or t[0].numel() * t.element_size() < _MIN_ROW_BYTES):
        return None
    rows = t.reshape(t.shape[0], -1).view(_WORDS[t.element_size()])
    kept, index, by_sum = [], [], {}
    for i, row in enumerate(rows):
        key = int(row.sum(dtype=torch.int64))
        for j in by_sum.get(key, ()):
            if torch.equal(row, rows[kept[j]]):
                index.append(j)
                break
        else:
            by_sum.setdefault(key, []).append(len(kept))
            index.append(len(kept))
            kept.append(i)
    if len(kept) == len(index):
        return None
    return t[kept], np.asarray(index, np.int64)


def _host(leaf):
    """(array, {suffix: value}) for one leaf: the slot count of a
    broadcast leaf, the row index of one with repeated rows."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), {}
    t = leaf.detach()
    extra = {}
    if t.dim() >= 1 and t.shape[0] > 1 and t.stride(0) == 0:
        extra[SLOTS_SUFFIX], t = np.int64(t.shape[0]), t[0]
    else:
        repeated = _repeated_rows(t)
        if repeated is not None:
            t, extra[ROWS_SUFFIX] = repeated
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy(), extra


def _atomic_replace(tmp: str, path: str) -> None:
    """fsync the temp file, rename it over the target, fsync the
    directory."""
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def write_json_atomic(path: str, payload: Any) -> None:
    """Serialize ``payload`` to ``path`` via write-temp-fsync-rename."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    _atomic_replace(tmp, path)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def save(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` (tensors on any device, ints, arrays) as step
    ``step``; returns the file's path. The ``.npz`` is ``np.savez``'s
    (uncompressed, zip64 members), written a leaf at a time, so the host
    holds one leaf's copy, not the whole tree's (a full-width async state
    is ~27 GB)."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, step)
    tmp = path + ".tmp.npz"
    names = []
    with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        def put(key, a):
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(a),
                                          allow_pickle=False)
            names.append(key)

        put(PORT_KEY, np.int32(1))
        for key, leaf in flatten_with_paths(tree).items():
            a, extra = _host(leaf)
            put(key, a)
            del a
            for suffix, value in extra.items():
                put(key + suffix, value)
    _atomic_replace(tmp, path)
    write_json_atomic(os.path.join(directory, "treedef.json"),
                      {"treedef": sorted(k for k in names if k != PORT_KEY),
                       "step": step})
    return path


def all_steps(directory: str) -> list:
    """Checkpoint steps present in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.match(r"ckpt_(\d+)\.npz$", name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


_READ_CHUNK = 1 << 26


def _read_member(zf: zipfile.ZipFile, name: str) -> np.ndarray:
    """One ``.npy`` member of an ``.npz``, read in 64 MiB chunks (the zip
    member's CRC still checked): ``np.load`` reads a zip member 256 KiB
    at a time, which on a network file system costs a round trip each."""
    with zf.open(name) as f:
        major, _ = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if major == 1
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        if dtype.hasobject:
            raise ValueError(f"{name}: object arrays are not read")
        a = np.empty(shape, dtype, order="F" if fortran else "C")
        buf = memoryview(a.reshape(-1, order="A")).cast("B")
        done = 0
        while done < len(buf):
            n = f.readinto(buf[done:done + _READ_CHUNK])
            if not n:
                raise EOFError(f"{name}: {len(buf) - done} bytes missing")
            done += n
        if f.read(1):
            raise ValueError(f"{name}: trailing bytes")
    return a


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """Every array of one file, read in full (a torn file raises one of
    :data:`CORRUPT_ERRORS` here)."""
    with zipfile.ZipFile(path) as zf:
        return {name[:-len(".npy")]: _read_member(zf, name)
                for name in zf.namelist() if name.endswith(".npy")}


def expanded_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A port file's arrays as plain leaves: each once-stored slot leaf
    broadcast back over its slots (no copy), a leaf stored as its
    distinct rows expanded, the format keys dropped."""
    out = {}
    for key, a in arrays.items():
        if key == PORT_KEY or key.endswith((SLOTS_SUFFIX, ROWS_SUFFIX)):
            continue
        slots = arrays.get(key + SLOTS_SUFFIX)
        rows = arrays.get(key + ROWS_SUFFIX)
        if slots is not None:
            a = np.broadcast_to(a, (int(slots),) + a.shape)
        elif rows is not None:
            a = a[rows]
        out[key] = a
    return out


def restore_arrays(arrays: Dict[str, np.ndarray], template: Any,
                   key_prefix: str = "") -> Any:
    """``template``'s structure filled from one port file's arrays: each
    leaf with the template leaf's dtype, device and shape (a mismatch
    raises AssertionError), a once-stored slot leaf as a broadcast
    view. ``key_prefix`` reads a subtree of a larger saved tree (e.g.
    ``.inner/.params/`` for the params of a full program state)."""
    if PORT_KEY not in arrays:
        raise ValueError("not a repro_torch checkpoint (no "
                         f"{PORT_KEY!r} key): convert a reference file "
                         "with repro_torch.convert")
    values = {}
    for key, like in flatten_with_paths(template).items():
        full = key_prefix + key
        a = arrays[full]
        if isinstance(like, (np.ndarray, np.generic)):
            # a host array (the async schedule) keeps its numpy type
            values[key] = (np.array(a, like.dtype)
                           if isinstance(like, np.ndarray)
                           else like.dtype.type(a))
            continue
        if not isinstance(like, torch.Tensor):
            values[key] = type(like)(a) if isinstance(like, (int, float)) \
                else a
            continue
        t = torch.from_numpy(a)
        if like.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        # a copy in the allocator's own memory: numpy's buffers are less
        # aligned, and the CPU's math libraries may round differently on
        # them, which would break a bitwise resume
        t = t.to(device=like.device, dtype=like.dtype, copy=True)
        slots = arrays.get(full + SLOTS_SUFFIX)
        rows = arrays.get(full + ROWS_SUFFIX)
        if slots is not None:
            t = t[None].expand((int(slots),) + tuple(t.shape))
        elif rows is not None:
            t = t.index_select(0, torch.from_numpy(np.asarray(rows)).to(
                t.device))
        assert tuple(t.shape) == tuple(like.shape), (key, tuple(t.shape),
                                                     tuple(like.shape))
        values[key] = t
    return _rebuild(template, values)


def restore(directory: str, template: Any, step: Optional[int] = None,
            key_prefix: str = "") -> Any:
    """Restore into the structure of ``template`` (see
    :func:`restore_arrays`).

    With ``step=None`` the newest readable checkpoint wins: a corrupt
    newest file (a torn write from a crash) is skipped with a warning and
    the next older step is tried. A pinned ``step`` is never
    substituted: corruption there raises.
    """
    candidates = [step] if step is not None else all_steps(directory)[::-1]
    if not candidates:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    errors = []
    for s in candidates:
        try:
            arrays = load_arrays(checkpoint_path(directory, s))
            break
        except CORRUPT_ERRORS as e:
            if step is not None:
                raise
            errors.append(s)
            warnings.warn(f"checkpoint step {s} unreadable "
                          f"({type(e).__name__}: {e}); falling back to the "
                          f"previous step", stacklevel=2)
    else:
        raise FileNotFoundError(f"no readable checkpoint in {directory}; "
                                f"tried steps {errors}")
    return restore_arrays(arrays, template, key_prefix)
