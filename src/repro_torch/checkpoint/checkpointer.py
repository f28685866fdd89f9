"""npz checkpointer for trees of tensors.

Port of ``repro/checkpoint/checkpointer.py`` with the same format on
disk, so a checkpoint written by either package restores in the other:
one ``np.savez_compressed`` archive a step (``ckpt_<step:08d>.npz``),
each leaf under its key path (dict keys sorted, list indices: the
reference's ``_flatten``), and a merged ``meta.json``.  Tensors come in
and go out; ``restore_checkpoint`` takes a ``device`` where the
reference takes ``shardings``.

  * **Integrity**: every save records a crc32 a leaf in meta.json;
    ``restore_checkpoint`` and ``verify_checkpoint`` check it and name the
    corrupt leaf, and ``latest_valid_step`` resumes past corrupt or
    partial steps (``--resume auto``).  Stray ``*.tmp`` files of a writer
    killed mid-save are ignored and reported.
  * **Atomic writes**: the ``.npz`` and ``meta.json`` are written under a
    ``.tmp`` name and ``os.replace``d into place.
  * **Partitioned (ZeRO) state**: ``save_checkpoint(partition=play.spec())``
    records the partition (worker count, true bucket sizes) per step;
    ``restore_checkpoint(repartition=True)`` re-shards each saved
    shard-bucket leaf whose shape disagrees with the template
    (``core/resharding.py``), so a run saved at W workers restores at W′.
  * **Precision**: bf16 and f16 leaves are widened to f32 on disk
    (``.float()`` before ``.numpy()``: numpy has no bf16, and the
    widening is exact); a restored leaf whose dtype differs from the
    template's is cast by torch (round to nearest even, the bits of the
    reference's ``ml_dtypes`` cast).  ``save_checkpoint(precision=
    policy.spec())`` records the policy per step; ``read_precision``
    returns it.
"""

from __future__ import annotations

import json
import os
import re
import warnings
import zlib

import numpy as np
import torch

from repro_torch.core.resharding import reshard_bucket  # noqa: F401


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _unflatten_into(template, flat: dict, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat,
                                   f"{prefix}.{k}" if prefix else str(k))
                for k in template}
    if isinstance(template, (list, tuple)):
        t = type(template)
        return t(_unflatten_into(v, flat, f"{prefix}.{i}")
                 for i, v in enumerate(template))
    return flat[prefix]


def _to_disk(leaf) -> np.ndarray:
    """A tensor leaf as the array written to disk: bf16 and f16 widened to
    f32 (lossless), everything else as it is."""
    t = leaf.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    partition: dict | None = None,
                    precision: dict | None = None) -> str:
    """Atomically write ``tree`` as ``ckpt_<step>.npz`` + meta.json.

    ``partition``: the ZeRO partition spec (``PartitionedLayout.spec()``:
    {"n_parts", "bucket_sizes"}) of the saved shard-bucket leaves, so a
    later restore can re-shard them.  ``precision``: a PrecisionPolicy
    spec (``policy.spec()``).  Both are kept per step in meta.json."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, checksums = {}, {}
    for path, leaf in _flatten(tree):
        arr = _to_disk(leaf)
        arrays[path] = arr
        checksums[path] = _crc(arr)
    fname = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:  # a file handle: savez appends no suffix
        np.savez_compressed(f, **arrays)
    os.replace(tmp, fname)
    # meta is MERGED and its specs are keyed by step, so a later save
    # without a partition never orphans an earlier partitioned step
    meta = read_meta(ckpt_dir)
    meta["latest"] = step
    meta.setdefault("checksums", {})[str(step)] = checksums
    if partition is not None:
        meta.setdefault("partitions", {})[str(step)] = partition
    if precision is not None:
        meta.setdefault("precision", {})[str(step)] = precision
    mpath = os.path.join(ckpt_dir, "meta.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(meta, f)
    os.replace(mpath + ".tmp", mpath)
    return fname


def read_meta(ckpt_dir: str) -> dict:
    mpath = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(mpath):
        return {}
    with open(mpath) as f:
        return json.load(f)


def read_precision(ckpt_dir: str, step: int) -> dict | None:
    """The PrecisionPolicy spec recorded for ``step`` (None if absent)."""
    return read_meta(ckpt_dir).get("precision", {}).get(str(step))


def stray_tmp_files(ckpt_dir: str) -> list:
    """Leftover ``*.tmp`` files of a writer killed mid-save: never the
    latest checkpoint, but worth reporting."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".tmp"))


def _warn_stray_tmp(ckpt_dir: str):
    stray = stray_tmp_files(ckpt_dir)
    if stray:
        warnings.warn(
            f"{ckpt_dir}: ignoring {len(stray)} stray tmp file(s) left by a "
            f"killed mid-save writer: {', '.join(stray)}", stacklevel=3)


def _steps(ckpt_dir: str) -> list:
    return [int(m.group(1)) for m in
            (re.match(r"ckpt_(\d+)\.npz$", f) for f in os.listdir(ckpt_dir))
            if m]


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    _warn_stray_tmp(ckpt_dir)
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def verify_checkpoint(ckpt_dir: str, step: int):
    """Integrity check of one step: None if clean, else the reason.  Every
    ``.npz`` member must decompress and match its recorded crc32 (a
    checkpoint without checksums gets the decompression check only)."""
    fname = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    if not os.path.exists(fname):
        return f"ckpt_{step:08d}.npz missing"
    cks = read_meta(ckpt_dir).get("checksums", {}).get(str(step))
    try:
        with np.load(fname) as data:
            for k in data.files:
                try:
                    arr = data[k]
                except Exception as e:  # zlib, zipfile and format errors
                    return f"leaf {k!r} unreadable ({e})"
                if cks is not None and k in cks:
                    got = _crc(arr)
                    if got != cks[k]:
                        return (f"leaf {k!r} corrupt (crc32 {got:#010x} != "
                                f"recorded {cks[k]:#010x})")
            if cks is not None:
                missing = sorted(set(cks) - set(data.files))
                if missing:
                    return f"leaves missing from archive: {missing}"
    except Exception as e:  # a truncated or foreign archive
        return f"archive unreadable ({e})"
    return None


def latest_valid_step(ckpt_dir: str):
    """Newest step that passes :func:`verify_checkpoint` (None if none);
    corrupt or partial steps are skipped with a warning naming why."""
    if not os.path.isdir(ckpt_dir):
        return None
    _warn_stray_tmp(ckpt_dir)
    for step in sorted(_steps(ckpt_dir), reverse=True):
        reason = verify_checkpoint(ckpt_dir, step)
        if reason is None:
            return step
        warnings.warn(f"{ckpt_dir}: skipping step {step}: {reason}",
                      stacklevel=2)
    return None


def _bucket_indices(paths, head):
    return {int(p.rpartition(".")[2]) for p in paths
            if p.rpartition(".")[0] == head and p.rpartition(".")[2].isdigit()}


def restore_checkpoint(ckpt_dir: str, step: int, template, device=None,
                       repartition: bool = False):
    """Restore into the structure of ``template`` (tensors, meta tensors
    included): each leaf a tensor of its template leaf's shape and torch
    dtype on ``device`` (the CPU when None).

    ``repartition=True``: shard-bucket leaves saved under a recorded
    partition whose shapes disagree with the template are re-sharded for
    the template's worker count.  A bucket is named by the last index of
    its path ("opt_state.m.3" is bucket 3), so the template must have the
    save's bucket layout (``bucket_bytes``); another bucket count is
    rejected, never zero-filled."""
    fname = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    _warn_stray_tmp(ckpt_dir)
    cks = read_meta(ckpt_dir).get("checksums", {}).get(str(step))
    flat = {}
    with np.load(fname) as data:
        files = list(data.files)
        for k in files:
            try:
                flat[k] = data[k]
            except Exception as e:  # zlib, zipfile and format errors
                raise ValueError(
                    f"{fname}: leaf {k!r} is corrupt — unreadable ({e})"
                ) from e
            if cks is not None and k in cks:
                got = _crc(flat[k])
                if got != cks[k]:
                    raise ValueError(
                        f"{fname}: leaf {k!r} is corrupt — crc32 "
                        f"{got:#010x} does not match the recorded "
                        f"{cks[k]:#010x}")
    if repartition:
        part = read_meta(ckpt_dir).get("partitions", {}).get(str(step))
        if part is None:
            raise ValueError("repartition=True but the checkpoint records "
                             "no partition spec (save with partition=...)")
        sizes = part["bucket_sizes"]
        resharded = set()
        tpaths = [p for p, _ in _flatten(template)]
        for path, want in _flatten(template):
            saved = flat.get(path)
            head, _, idx = path.rpartition(".")
            if saved is None or not idx.isdigit():
                continue
            wshape = tuple(getattr(want, "shape", ()))
            if tuple(saved.shape) != wshape:
                if int(idx) >= len(sizes):
                    raise ValueError(
                        f"{path}: bucket {idx} outside the recorded "
                        f"partition ({len(sizes)} buckets) — template "
                        "built with a different bucket layout")
                if _prod(wshape) < sizes[int(idx)]:
                    raise ValueError(
                        f"{path}: template holds {_prod(wshape)} elements "
                        f"but bucket {idx} carries {sizes[int(idx)]} — "
                        "template built with a different bucket layout")
                flat[path] = reshard_bucket(saved, sizes[int(idx)], wshape)
                resharded.add(head)
        # every saved bucket of a re-sharded list must be consumed: a
        # template with FEWER buckets would silently drop the tail's state
        for head in resharded:
            saved_idx = _bucket_indices(files, head)
            templ_idx = _bucket_indices(tpaths, head)
            if saved_idx != templ_idx:
                raise ValueError(
                    f"{head}: checkpoint has buckets {sorted(saved_idx)} "
                    f"but template expects {sorted(templ_idx)} — bucket "
                    "layout (bucket_bytes) must match the save")
    tree = _unflatten_into(template, flat)
    dev = torch.device("cpu") if device is None else torch.device(device)

    def to_template(x, want):
        t = torch.from_numpy(x if x.flags.c_contiguous else x.copy())
        wd = getattr(want, "dtype", None)
        if isinstance(wd, torch.dtype) and t.dtype != wd:
            t = t.to(wd)  # the casted restore: f32 on disk → bf16 params
        return t.to(dev)

    return _map2(to_template, tree, template)


def _map2(fn, tree, template):
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], template[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, a, b) for a, b in zip(tree, template))
    return fn(tree, template)
