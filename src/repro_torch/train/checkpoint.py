"""Checkpoints: the port of ``repro.train.checkpoint``.

A snapshot is an ``.npz`` under the reference's keys (``__step__``,
``p/…``, ``o/m/…``, ``o/v/…``, ``o/step``, ``x/…``; the JAX layout,
:func:`repro_torch.weights.state_leaves`), so each package reads the
other's files.  It is written stored, as ``np.savez`` writes it, not
compressed: random fp32 weights do not compress, and ``savez_compressed``
runs at about 17 MB/s on the host, which for a full-size model is most of
an hour.  Each leaf goes to the host and into the archive one at a time;
over a mesh every rank gathers it (``specs.gather_leaf``, ZeRO-1's flat
moments to the reference's global flat arrays) and rank 0 writes it, and
a barrier follows.  On restore every rank reads the file and cuts its own
slices (``specs.shard_leaf``).  Files are atomic: a tempfile in the same
directory, then ``os.replace``.

* :func:`load_checkpoint` raises :class:`CheckpointError` with the
  offending key, the shape mismatch, or the nearest stored keys when a
  name is missing; it reads and checks every leaf before it writes any,
  so a failed load leaves the state as it was.
* :class:`CheckpointManager` keeps the last K snapshots of a run
  directory with a ``manifest.json`` of each file's SHA-256 and size.
* :meth:`CheckpointManager.restore_latest` walks them newest first,
  skipping a file whose checksum no longer matches or that fails to load,
  then unmanifested ``ckpt_*.npz`` strays, unverified.
"""
from __future__ import annotations

import difflib
import hashlib
import json
import os
import re
import tempfile
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sharding import comm
from repro_torch.weights import (global_shape, leaf_from_numpy, leaf_to_numpy,
                                 opt_step, state_leaves, with_opt_step)

MANIFEST = "manifest.json"
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")


class CheckpointError(RuntimeError):
    """A checkpoint file is missing keys, shape-mismatched, or unreadable."""


def _put(zf: zipfile.ZipFile, key: str, arr) -> None:
    """One member, as ``np.savez`` writes it."""
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    extra=None, *, cfg=None, mesh=None) -> None:
    """Write one snapshot.  ``extra`` is the sentinel's carry (``x/``).
    Over a mesh (``cfg`` given) every rank calls it."""
    leaves = state_leaves(params, opt_state, extra, cfg=cfg, mesh=mesh)
    writer = mesh is None or mesh.rank == 0
    zf = tmp = None
    if writer:
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
        os.close(fd)
        zf = zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True)
    try:
        if writer:
            _put(zf, "__step__", np.int64(step))
            if opt_state is not None:
                _put(zf, "o/step", np.int32(opt_step(opt_state)))
        for leaf in leaves:
            arr = leaf_to_numpy(leaf, mesh)
            if writer:
                _put(zf, leaf.key, arr)
        if writer:
            zf.close()
            os.replace(tmp, path)
    except BaseException:
        if writer:
            zf.close()
            os.remove(tmp)
        raise
    if mesh is not None:
        comm.barrier(mesh.axes)


def load_checkpoint(path: str, params_like, opt_like=None, extra_like=None,
                    *, cfg=None, mesh=None):
    """Restore a snapshot into ``params_like``, ``opt_like`` and
    ``extra_like`` (the port's trees, the rank's slices over a mesh), in
    place.  Returns ``(params, opt_state, step)``, or ``(params,
    opt_state, step, extra)`` when ``extra_like`` is given; the optimizer
    state is a new object where its step clock changed.  Raises
    :class:`CheckpointError` on an unreadable file, a missing key (named,
    with the nearest stored ones), or a shape mismatch."""
    try:
        data = np.load(path, allow_pickle=False)
    except Exception as e:                      # zipfile/OSError/ValueError
        raise CheckpointError(f"cannot read checkpoint {path!r}: {e}") from e
    leaves = state_leaves(params_like, opt_like, extra_like, cfg=cfg,
                          mesh=mesh)
    with data:
        try:
            keys = set(data.files)
            if "__step__" not in keys:
                raise CheckpointError(
                    f"checkpoint {path!r} has no '__step__' entry — not a "
                    f"checkpoint produced by save_checkpoint")
            step = int(data["__step__"])

            def need(key):
                if key not in keys:
                    near = difflib.get_close_matches(key, keys, n=3)
                    hint = f"; nearest stored keys: {near}" if near else ""
                    raise CheckpointError(
                        f"checkpoint {path!r} is missing key {key!r}{hint}")
                return data[key]

            staged = []
            for leaf in leaves:
                arr = need(leaf.key)
                want = global_shape(leaf, mesh)
                if arr.shape != want:
                    raise CheckpointError(
                        f"checkpoint {path!r} key {leaf.key!r}: stored shape "
                        f"{arr.shape} != expected {want}")
                staged.append((leaf, arr))
            o_step = (int(need("o/step")) if opt_like is not None
                      else None)
        except CheckpointError:
            raise
        except Exception as e:                  # truncated member mid-read
            raise CheckpointError(
                f"checkpoint {path!r} is corrupt: {e}") from e
    for leaf, arr in staged:
        leaf_from_numpy(leaf, arr, mesh)
    opt_state = (with_opt_step(opt_like, o_step) if opt_like is not None
                 else None)
    if extra_like is None:
        return params_like, opt_state, step
    return params_like, opt_state, step, extra_like


# =============================================================================
# Keep-last-K rotation with a checksummed manifest
# =============================================================================

def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    """Rotating checkpoints under one run directory.

    ``save(step, ...)`` writes ``ckpt_<step>.npz``, records its SHA-256
    and size in ``manifest.json`` (both atomically) and prunes beyond
    ``keep`` snapshots; ``restore_latest(...)`` restores the newest
    snapshot that passes its checksum and loads, falling back through the
    rotation, and returns ``None`` if none does.  Over a mesh (``cfg``
    and ``mesh`` given) every rank calls both; rank 0 writes.  ``saves``
    and ``restored`` record each save's and the restore's bytes and
    seconds."""

    def __init__(self, directory: str, keep: int = 3, *, cfg=None,
                 mesh=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir, self.keep = directory, keep
        self.cfg, self.mesh = cfg, mesh
        self.saves: List[Dict[str, Any]] = []
        self.restored: Optional[Dict[str, Any]] = None
        if self._writer:
            os.makedirs(directory, exist_ok=True)

    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    # ------------------------------------------------------------- manifest
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST)

    def _read_manifest(self) -> List[Dict[str, Any]]:
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
            entries = m.get("checkpoints", [])
            return [e for e in entries
                    if isinstance(e, dict) and "file" in e and "step" in e]
        except (OSError, ValueError):
            return []

    def _write_manifest(self, entries: List[Dict[str, Any]]) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump({"checkpoints": entries}, f, indent=1)
        os.replace(tmp, self.manifest_path)

    # ----------------------------------------------------------------- save
    def path_for(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, params, opt_state=None, extra=None) -> str:
        path = self.path_for(step)
        t0 = time.perf_counter()
        save_checkpoint(path, params, opt_state, step, extra=extra,
                        cfg=self.cfg, mesh=self.mesh)
        rec = {"step": int(step), "save_s": time.perf_counter() - t0}
        if self._writer:
            t0 = time.perf_counter()
            digest = sha256(path)
            rec.update(sha256_s=time.perf_counter() - t0,
                       bytes=os.path.getsize(path))
            entries = [e for e in self._read_manifest()
                       if e["file"] != os.path.basename(path)]
            entries.append({"file": os.path.basename(path), "step": int(step),
                            "sha256": digest, "bytes": rec["bytes"]})
            entries.sort(key=lambda e: e["step"])
            while len(entries) > self.keep:
                victim = entries.pop(0)
                try:
                    os.remove(os.path.join(self.dir, victim["file"]))
                except OSError:
                    pass
            self._write_manifest(entries)
        if self.mesh is not None:
            comm.barrier(self.mesh.axes)
        self.saves.append(rec)
        return path

    # -------------------------------------------------------------- restore
    def candidates(self) -> List[Tuple[str, Optional[str]]]:
        """(path, expected sha256 or None) newest first: manifest entries,
        then unmanifested ``ckpt_*.npz`` strays (unverifiable)."""
        entries = sorted(self._read_manifest(), key=lambda e: -e["step"])
        out = [(os.path.join(self.dir, e["file"]), e.get("sha256"))
               for e in entries]
        known = {p for p, _ in out}
        strays = []
        for name in (os.listdir(self.dir) if os.path.isdir(self.dir)
                     else ()):
            m = _CKPT_RE.match(name)
            p = os.path.join(self.dir, name)
            if m and p not in known:
                strays.append((int(m.group(1)), p))
        out += [(p, None) for _, p in sorted(strays, reverse=True)]
        return out

    def restore_latest(self, params_like, opt_like=None, extra_like=None,
                       log=print):
        """The newest valid snapshot restored (``load_checkpoint``'s
        tuple), or ``None``.  Corrupt or mismatched entries are reported
        through ``log`` and skipped: the fallback walk."""
        for path, sha in self.candidates():
            if not os.path.exists(path):
                continue
            t0 = time.perf_counter()
            if sha is not None and sha256(path) != sha:
                log(f"checkpoint {path} fails its manifest checksum — "
                    f"skipping (falling back to previous snapshot)")
                continue
            t1 = time.perf_counter()
            try:
                got = load_checkpoint(path, params_like, opt_like,
                                      extra_like, cfg=self.cfg,
                                      mesh=self.mesh)
            except CheckpointError as e:
                log(f"checkpoint {path} is unrestorable ({e}) — falling "
                    f"back to previous snapshot")
                continue
            self.restored = {"step": got[2], "path": path,
                             "bytes": os.path.getsize(path),
                             "sha256_s": t1 - t0,
                             "load_s": time.perf_counter() - t1}
            return got
        return None
