"""Sharded-checkpoint manifest (port of
``paddle_tpu/distributed/checkpoint/sharded/manifest.py``): the on-disk
index one checkpoint directory carries, in the same format, so either
package reads what the other wrote.

One committed checkpoint directory holds ``manifest.json`` plus one raw
piece file per (tensor, shard):

.. code-block:: json

    {
      "format": "paddle_tpu_sharded_ckpt_v1",
      "created_unix": 1754300000.0,
      "entries": {
        "gpt.h.0.attn.qkv_proj.weight": {
          "shape": [768, 2304],
          "dtype": "float32",
          "spec": null,
          "pieces": [
            {"file": "0004_gpt.h.0.attn.qkv_proj.weight.p0.bin",
             "index": [[0, 768], [0, 2304]],
             "sha256": "...", "bytes": 7077888}
          ]
        }
      }
    }

- ``index`` is the piece's half-open ``[start, stop)`` bounds per dim of
  the whole tensor; the pieces of one entry are disjoint and cover it
  exactly (:func:`verify_dir` checks both). A JAX save across devices
  writes one piece per shard; the port writes one piece per tensor;
- ``spec`` is the PartitionSpec the JAX array carried at save time, or
  ``null``; the port writes ``null`` and reads any;
- piece payloads are raw C-order little-endian bytes (``.bin``). The
  dtype is named as numpy names it (``float32``, ``bfloat16``, ...); the
  port reads and writes every piece through torch (raw bytes viewed as
  the torch dtype of that name), so ``bfloat16`` needs no ``ml_dtypes``;
- ``sha256`` is over the piece file's bytes: a torn, truncated or
  bit-rotted piece fails by name at load or verify time.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
from typing import List

import torch

MANIFEST_NAME = "manifest.json"
FORMAT = "paddle_tpu_sharded_ckpt_v1"
PIECE_SUFFIX = ".bin"
TMP_PREFIX = ".tmp_"

__all__ = ["MANIFEST_NAME", "FORMAT", "PIECE_SUFFIX", "TMP_PREFIX",
           "dtype_name", "piece_filename", "read_manifest", "sha256_file",
           "torch_dtype", "verify_dir"]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype string (numpy's names, which
    torch shares: ``float32``, ``bfloat16``, ``int64``, ``bool``, ...)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown checkpoint dtype {name!r}")
    return dt


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest string of a torch dtype (its numpy name)."""
    return str(dtype).replace("torch.", "")


def piece_filename(ordinal: int, name: str, piece: int) -> str:
    """Deterministic piece file name: entry ordinal (uniqueness even for
    os-hostile tensor names) + sanitized name (greppability) + piece
    index."""
    san = re.sub(r"[^A-Za-z0-9_.\-]", "_", name)[:80]
    return f"{ordinal:04d}_{san}.p{piece}{PIECE_SUFFIX}"


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def read_manifest(directory: str) -> dict:
    """Parse + structurally validate one checkpoint's manifest. Loud on
    every failure mode: no manifest (not a sharded checkpoint — or an
    uncommitted tmp dir), unparseable json, wrong format string."""
    path = os.path.join(directory, MANIFEST_NAME)
    if not os.path.exists(path):
        hint = ""
        try:
            parent, base = os.path.split(os.path.abspath(str(directory)))
            stranded = sorted(
                n for n in os.listdir(parent)
                if n.startswith(f"{TMP_PREFIX}old_{base}_"))
            if stranded and not os.path.exists(str(directory)):
                hint = (
                    "; an interrupted overwrite stranded the previous "
                    f"checkpoint COMPLETE at {stranded[-1]!r} — rename it "
                    f"back to {base!r} to recover")
        except OSError:
            pass
        raise FileNotFoundError(
            f"{directory!r} holds no {MANIFEST_NAME} — not a committed "
            "sharded checkpoint (an interrupted save leaves only a "
            f"'{TMP_PREFIX}*' dir, which is not loadable by design)"
            + hint)
    try:
        with open(path) as f:
            man = json.load(f)
    except ValueError as e:
        raise ValueError(
            f"{path}: manifest is unparseable ({e}) — the checkpoint "
            "commit was torn; restore from a complete checkpoint") from None
    if man.get("format") != FORMAT:
        raise ValueError(
            f"{path}: format {man.get('format')!r} is not {FORMAT!r}")
    return man


# ------------------------------------------------------------------ verify
def _piece_numel(index: List[List[int]]) -> int:
    n = 1
    for start, stop in index:
        n *= max(int(stop) - int(start), 0)
    return n


def _overlaps(a: List[List[int]], b: List[List[int]]) -> bool:
    return all(max(a0, b0) < min(a1, b1)
               for (a0, a1), (b0, b1) in zip(a, b))


def verify_dir(directory: str, *, deep: bool = True) -> List[dict]:
    """Integrity + completeness pass over one checkpoint directory.

    Returns ``[]`` when healthy, else one problem row per defect:
    ``{"kind", "tensor", "piece", "problem"}`` with kinds

    - ``manifest``:  missing/unparseable/wrong-format manifest,
    - ``missing``:   a manifest-referenced piece file absent on disk,
    - ``corrupt``:   piece byte count or sha256 (``deep=True``) mismatch,
    - ``mismatch``:  piece bounds outside the tensor, overlapping
      pieces, or a piece set that does not cover the tensor,
    - ``orphan``:    an unreferenced piece file or stale writer tmp dir.

    """
    problems: List[dict] = []
    try:
        man = read_manifest(directory)
    except (FileNotFoundError, ValueError) as e:
        return [{"kind": "manifest", "tensor": None, "piece": None,
                 "problem": str(e)}]
    referenced = set()
    for name, entry in man.get("entries", {}).items():
        shape = [int(d) for d in entry.get("shape", [])]
        numel = math.prod(shape)
        itemsize = torch_dtype(entry["dtype"]).itemsize
        covered = 0
        indexes = []
        for piece in entry.get("pieces", []):
            fname = piece["file"]
            referenced.add(fname)
            index = [[int(a), int(b)] for a, b in piece["index"]]
            if (len(index) != len(shape)
                    or any(a < 0 or b > d or a >= b
                           for (a, b), d in zip(index, shape))):
                if shape or index:  # scalar entries carry an empty index
                    problems.append({
                        "kind": "mismatch", "tensor": name, "piece": fname,
                        "problem": f"piece bounds {index} do not fit the "
                                   f"tensor shape {shape}"})
                    continue
            path = os.path.join(directory, fname)
            if not os.path.exists(path):
                problems.append({
                    "kind": "missing", "tensor": name, "piece": fname,
                    "problem": "manifest-referenced piece file is absent "
                               "— the checkpoint is INCOMPLETE"})
                continue
            want_bytes = _piece_numel(index) * itemsize if shape \
                else itemsize
            size = os.path.getsize(path)
            if size != int(piece.get("bytes", want_bytes)) \
                    or size != want_bytes:
                problems.append({
                    "kind": "corrupt", "tensor": name, "piece": fname,
                    "problem": f"piece holds {size} bytes, manifest "
                               f"promises {want_bytes} — truncated or "
                               "torn write"})
                continue
            if deep and sha256_file(path) != piece.get("sha256"):
                problems.append({
                    "kind": "corrupt", "tensor": name, "piece": fname,
                    "problem": "sha256 mismatch — the piece bytes rotted "
                               "or were torn mid-write"})
                continue
            for other in indexes:
                if shape and _overlaps(index, other):
                    problems.append({
                        "kind": "mismatch", "tensor": name, "piece": fname,
                        "problem": f"piece bounds {index} overlap another "
                                   f"piece's {other}"})
            indexes.append(index)
            covered += _piece_numel(index) if shape else 1
        if covered != numel:
            problems.append({
                "kind": "mismatch" if covered > numel else "missing",
                "tensor": name, "piece": None,
                "problem": f"pieces cover {covered}/{numel} elements — "
                           "the piece set does not reassemble the tensor"})
    referenced.add(MANIFEST_NAME)
    for fname in sorted(os.listdir(directory)):
        full = os.path.join(directory, fname)
        if os.path.isdir(full):
            if fname.startswith(TMP_PREFIX):
                problems.append({
                    "kind": "orphan", "tensor": None, "piece": fname,
                    "problem": "stale writer tmp dir — an interrupted "
                               "save's droppings; prune it"})
            continue
        if fname not in referenced and fname.endswith(PIECE_SUFFIX):
            problems.append({
                "kind": "orphan", "tensor": None, "piece": fname,
                "problem": "piece file referenced by no manifest entry"})
    return problems
