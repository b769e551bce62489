"""Distributed (sharded) checkpoints of a train state, and elastic resume.

Port of ``paddle_tpu/distributed/checkpoint.py``. The JAX module hands
each array's ``NamedSharding`` to orbax. The port's state is plain local
tensors, one process a rank, so the caller says where each leaf's part
lies in the whole: a ``layout`` maps a leaf's path in the rank's tree
(``"params/layers/0/wq"``) to a ``Slice``, the leaf's global name, global
shape and the offsets of this rank's part, and whether this rank writes
it (a leaf replicated over a mesh axis is written once, by the rank at
index 0 of that axis). ``spec_layout`` derives it from partition specs
over the hybrid mesh; ``models.llama.checkpoint_layout`` and
``models.qwen2_moe.checkpoint_layout`` give a trainer's. A leaf the
layout does not name is whole and replicated (the JAX module's
assumption for host-local arrays); a path mapped to ``None`` (with
everything under it) is the rank's own, neither saved nor loaded.

The file format is the port's own (the JAX package writes orbax's): a
checkpoint is a directory of ``rank_<r>.bin`` (each written part's raw
bytes, one after another) and ``rank_<r>.json`` (each part's name,
global shape, offsets, local shape, dtype and place in the ``.bin``),
and ``objects.pkl``, the state's Python entries (``step``, the
optimizer's ``count``) pickled by the coordinator.

``load_state_dict`` fills a state on any mesh: each target leaf, given
its own layout, is filled from every saved part that overlaps its
slice, by copying into the live tensors under ``no_grad`` (gradient
hooks and optimizer references stay valid). So a dp 2 x tp 2 ZeRO 1
checkpoint loads into one device, into tp 4 or into dp 2 ZeRO 3.

Commit. Every rank writes into ``<path>.partial`` (a name
``checkpoint_steps`` skips), then drops a ``done`` marker named by the
save's token; the coordinator waits for every rank's marker, writes
``COMMIT`` and renames the directory to ``<path>``. No collective runs
on the training's process group after the call returns, so an async
writer thread never races the step's collectives; the token (a nonce
the ranks agree on at their first save, with a count of saves of that
path) keeps a crashed run's markers from committing a new save. The
root must be one filesystem every rank sees.

``async_save``: the call returns once this rank's parts are copied to
host memory it owns (``clone()`` on the CPU, where ``.cpu()`` would
return the live tensor; a device-to-host copy on the card), and a
thread writes and commits; ``wait_until_finished()`` joins it.
Successive async saves are serialized, as the JAX module's shared
``AsyncCheckpointer`` does.
"""
from __future__ import annotations

import json
import os
import pickle
import secrets
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["Slice", "spec_layout", "save_state_dict", "load_state_dict",
           "restart_attempt", "save_checkpoint", "checkpoint_steps",
           "latest_checkpoint", "load_latest_checkpoint"]

_COMMIT = "COMMIT"
_PARTIAL = ".partial"
# seconds a rank waits for the other ranks' parts (or for the commit)
COMMIT_TIMEOUT = 1800.0


class Slice(NamedTuple):
    """Where a rank's leaf lies in the whole: ``key`` the leaf's global
    name, ``shape`` its global shape, ``offsets`` where this rank's part
    starts, ``write`` whether this rank writes it (False: a replica that
    another rank writes)."""
    key: str
    shape: Tuple[int, ...]
    offsets: Tuple[int, ...]
    write: bool = True


# ---------------------------------------------------------------------------
# trees and layouts
# ---------------------------------------------------------------------------

def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` of nested dicts and lists (a tuple, such as a
    partition spec, is a leaf), paths joined by ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _set(tree, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree[int(k) if isinstance(tree, list) else k]
    if isinstance(tree, list):
        tree[int(last)] = value
    else:
        tree[last] = value


def _excluded(path: str, layout) -> bool:
    """A path mapped to None, or under one."""
    parts = path.split("/")
    return any(layout.get("/".join(parts[:i]), 0) is None
               for i in range(1, len(parts) + 1))


def _slice(path: str, t: torch.Tensor, layout, writer: bool) -> Slice:
    s = layout.get(path)
    if s is None:
        return Slice(path, tuple(t.shape), (0,) * t.dim(), writer)
    return Slice(s.key, tuple(s.shape), tuple(s.offsets), bool(s.write))


_REPLICATING_AXES = ("dp", "cp", "tp", "ep")


def spec_layout(tree, specs, mesh, rename=None) -> Dict[str, Slice]:
    """The ``Slice`` of every tensor leaf of a rank's ``tree`` whose
    ``specs`` tree (one structure) gives each leaf's partition spec over
    ``mesh`` (a ``parallel.HybridMesh``): a dim on an axis (or a tuple
    of axes, major first) is that axis's ``degree`` parts, this rank's
    at its ``axis_index``. A leaf is written by the rank at index 0 of
    every dp / cp / tp / ep axis its spec does not shard over (a pp
    stage's leaves are its own). ``rename(path)`` gives the global name
    (default: the path)."""
    out = {}
    spec_of = dict(_flatten(specs))
    for path, t in _flatten(tree):
        if not isinstance(t, torch.Tensor):
            continue
        spec = tuple(spec_of[path]) + (None,) * (t.dim() - len(spec_of[path]))
        shape, offsets, used = [], [], set()
        for n, ax in zip(t.shape, spec):
            axes = () if ax is None else (
                tuple(ax) if isinstance(ax, (tuple, list)) else (ax,))
            idx, parts = 0, 1
            for a in axes:
                idx = idx * mesh.degree(a) + mesh.axis_index(a)
                parts *= mesh.degree(a)
                used.add(a)
            shape.append(n * parts)
            offsets.append(idx * n)
        write = all(mesh.axis_index(a) == 0 for a in _REPLICATING_AXES
                    if a not in used and mesh.degree(a) > 1)
        out[path] = Slice(rename(path) if rename else path, tuple(shape),
                          tuple(offsets), write)
    return out


# ---------------------------------------------------------------------------
# ranks and tokens
# ---------------------------------------------------------------------------

def _rank_world(process_group) -> Tuple[int, int]:
    import torch.distributed as dist
    if process_group is not None and hasattr(process_group, "nranks"):
        return process_group.rank, process_group.nranks
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return (dist.get_rank(process_group),
            dist.get_world_size(process_group))


_NONCE: Dict[Any, str] = {}
_SEQ: Dict[str, int] = {}


def _nonce(process_group, coordinator_rank: int, world: int) -> str:
    """A nonce the ranks of the group agree on, drawn by the coordinator
    at their first save (one broadcast, on the calling thread)."""
    key = id(process_group)
    if key not in _NONCE:
        word = [secrets.token_hex(8)]
        if world > 1:
            import torch.distributed as dist
            pg = getattr(process_group, "pg", process_group)
            ranks = getattr(process_group, "ranks", None)
            src = ranks[coordinator_rank] if ranks else coordinator_rank
            dist.broadcast_object_list(word, src=src, group=pg)
        _NONCE[key] = word[0]
    return _NONCE[key]


def _token(path: str, nonce: str) -> str:
    _SEQ[path] = _SEQ.get(path, 0) + 1
    return f"{nonce}-{_SEQ[path]}"


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _stage(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that this call owns."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    return t.to("cpu")


def _raw(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _write_rank(tmp: str, rank: int, parts, objects, token: str) -> None:
    """This rank's files and its ``done`` marker."""
    os.makedirs(tmp, exist_ok=True)
    index, offset = [], 0
    bin_tmp = os.path.join(tmp, f"rank_{rank}.bin.{token}")
    with open(bin_tmp, "wb") as f:
        for sl, t in parts:
            raw = _raw(t)
            f.write(memoryview(raw))
            index.append({"key": sl.key, "shape": list(sl.shape),
                          "offsets": list(sl.offsets),
                          "local_shape": list(t.shape),
                          "dtype": str(t.dtype).replace("torch.", ""),
                          "offset": offset, "nbytes": int(raw.nbytes)})
            offset += int(raw.nbytes)
    os.replace(bin_tmp, os.path.join(tmp, f"rank_{rank}.bin"))
    _write_json(os.path.join(tmp, f"rank_{rank}.json"),
                {"rank": rank, "parts": index})
    if objects is not None:
        with open(os.path.join(tmp, "objects.pkl.tmp"), "wb") as f:
            pickle.dump(objects, f)
        os.replace(os.path.join(tmp, "objects.pkl.tmp"),
                   os.path.join(tmp, "objects.pkl"))
    with open(os.path.join(tmp, f"rank_{rank}.{token}.done"), "w"):
        pass


def _write_json(path: str, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + COMMIT_TIMEOUT
    pause = 0.005
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: {what} after "
                               f"{COMMIT_TIMEOUT} s")
        time.sleep(pause)
        pause = min(pause * 2, 0.1)


def _read_commit(path: str) -> Optional[str]:
    try:
        with open(os.path.join(path, _COMMIT)) as f:
            return f.read()
    except OSError:
        return None


def _commit(tmp: str, path: str, world: int, token: str) -> None:
    """The coordinator's part: every rank's marker, then the rename."""
    def all_done():
        return all(os.path.exists(os.path.join(tmp, f"rank_{r}.{token}.done"))
                   for r in range(world))

    _wait(all_done, f"{path}: not every rank's part arrived")
    # what a crashed save left (other ranks, markers, half-written files)
    keep = {"objects.pkl"} | {f"rank_{r}{ext}" for r in range(world)
                              for ext in (".bin", ".json", f".{token}.done")}
    for name in os.listdir(tmp):
        if name not in keep:
            os.remove(os.path.join(tmp, name))
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write(token)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _save_rank(state_dict, path: str, layout, rank: int, world: int,
               coordinator: int, token: str, async_save: bool):
    """Stage this rank's parts now; write and commit now or on a
    thread."""
    layout = layout or {}
    writer = rank == coordinator
    parts, objects = [], {} if writer else None
    for p, leaf in _flatten(state_dict):
        if _excluded(p, layout):
            continue
        if isinstance(leaf, torch.Tensor):
            sl = _slice(p, leaf, layout, writer)
            if sl.write:
                parts.append((sl, _stage(leaf) if async_save
                              else leaf.detach().cpu()))
        elif writer:
            objects[p] = leaf
    tmp = path + _PARTIAL

    def work():
        _write_rank(tmp, rank, parts, objects, token)
        parts.clear()
        if writer:
            _commit(tmp, path, world, token)
        else:
            _wait(lambda: _read_commit(path) == token,
                  f"{path} was not committed")

    if not async_save:
        work()
        return _Done()
    return _Async(work)


class _Done:
    """A finished save (the synchronous path); ``finished_at``:
    ``time.perf_counter()`` once committed."""

    def __init__(self):
        self.finished_at = time.perf_counter()

    def wait_until_finished(self) -> None:
        return None


class _Async:
    """A save whose parts a thread writes and commits (``finished_at`` as
    ``_Done``'s, once finished)."""

    def __init__(self, work):
        self.finished_at = None
        self._err = None

        def run():
            try:
                work()
                self.finished_at = time.perf_counter()
            except BaseException as e:     # re-raised by the waiter
                self._err = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="paddle_tpu_torch-ckpt")
        self._thread.start()

    def wait_until_finished(self) -> None:
        self._thread.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err


_LAST: List[Optional[_Async]] = [None]


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    async_save: bool = False, layout=None):
    """Save ``state_dict`` (nested dicts and lists of tensors and Python
    values) to the directory ``path``, every rank of ``process_group``
    (default: the world) its parts by ``layout`` (module docstring).
    Returns an object with ``wait_until_finished()``: with ``async_save``
    the call returns once the parts are staged in host memory, and the
    files are readable once it has waited; a later save first waits for
    this one."""
    path = os.path.abspath(path)
    prev = _LAST[0]
    if prev is not None:
        _LAST[0] = None
        prev.wait_until_finished()
    rank, world = _rank_world(process_group)
    token = _token(path, _nonce(process_group, coordinator_rank, world))
    out = _save_rank(state_dict, path, layout, rank, world,
                     coordinator_rank, token, async_save)
    if async_save:
        _LAST[0] = out
    return out


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

_DTYPES = {n: getattr(torch, n) for n in (
    "float32", "float64", "float16", "bfloat16", "int8", "uint8", "int16",
    "int32", "int64", "bool", "complex64")}


class _Parts:
    """A checkpoint's saved parts by global name, read lazily."""

    def __init__(self, path: str):
        self.path = path
        self.by_key: Dict[str, list] = {}
        self._maps: Dict[int, np.memmap] = {}
        names = sorted(n for n in os.listdir(path)
                       if n.startswith("rank_") and n.endswith(".json"))
        if not names:
            raise FileNotFoundError(f"no checkpoint parts under {path}")
        for name in names:
            with open(os.path.join(path, name)) as f:
                meta = json.load(f)
            for part in meta["parts"]:
                part["rank"] = meta["rank"]
                self.by_key.setdefault(part["key"], []).append(part)
        objs = os.path.join(path, "objects.pkl")
        self.objects = {}
        if os.path.exists(objs):
            with open(objs, "rb") as f:
                self.objects = pickle.load(f)

    def tensor(self, part) -> torch.Tensor:
        r = part["rank"]
        if r not in self._maps:
            self._maps[r] = np.memmap(
                os.path.join(self.path, f"rank_{r}.bin"), dtype=np.uint8,
                mode="r")
        raw = self._maps[r][part["offset"]:part["offset"] + part["nbytes"]]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # a read-only mapping
            t = torch.from_numpy(raw)
        return t.view(_DTYPES[part["dtype"]]).reshape(part["local_shape"])


def _fill(target: torch.Tensor, sl: Slice, parts: _Parts) -> None:
    saved = parts.by_key.get(sl.key)
    if not saved:
        raise KeyError(f"checkpoint {parts.path} has no {sl.key!r}")
    covered = 0
    for part in saved:
        if list(part["shape"]) != list(sl.shape):
            raise ValueError(
                f"{sl.key}: saved global shape {part['shape']}, target "
                f"{list(sl.shape)}")
        src_ix, dst_ix, n = [], [], 1
        for lo, size, plo, psize in zip(sl.offsets, target.shape,
                                        part["offsets"],
                                        part["local_shape"]):
            a, b = max(lo, plo), min(lo + size, plo + psize)
            if a >= b:
                n = 0
                break
            src_ix.append(slice(a - plo, b - plo))
            dst_ix.append(slice(a - lo, b - lo))
            n *= b - a
        if n == 0:
            continue
        src = parts.tensor(part)[tuple(src_ix)]
        if src.dtype != target.dtype:
            raise TypeError(f"{sl.key}: saved {src.dtype}, target "
                            f"{target.dtype}")
        target[tuple(dst_ix)].copy_(src)
        covered += n
    if covered != target.numel():
        raise ValueError(f"{sl.key}: the saved parts cover {covered} of "
                         f"the target's {target.numel()} elements")


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    offload: bool = False, layout=None):
    """Fill ``state_dict`` in place from the checkpoint at ``path``: each
    tensor leaf, laid out by ``layout``, from every saved part that
    overlaps it (copied into the tensor itself), each Python entry
    replaced by its saved value. Returns ``state_dict``."""
    del process_group, coordinator_rank, offload
    layout = layout or {}
    parts = _Parts(os.path.abspath(path))
    with torch.no_grad():
        for p, leaf in _flatten(state_dict):
            if _excluded(p, layout):
                continue
            if isinstance(leaf, torch.Tensor):
                _fill(leaf, _slice(p, leaf, layout, True), parts)
            elif p in parts.objects:
                _set(state_dict, p, parts.objects[p])
            else:
                raise KeyError(f"checkpoint {path} has no {p!r}")
    return state_dict


# ---------------------------------------------------------------------------
# elastic resume: stepped checkpoints + restart-attempt plumbing
# ---------------------------------------------------------------------------
# The launcher (distributed.launch) exports PADDLE_RESTART_ATTEMPT on every
# attempt; these helpers save per-step directories, find the newest
# committed one (a step_<n> directory exists only once every rank's parts
# are in it), fill the live state and hand back the step to go on from.

def restart_attempt() -> int:
    """Which elastic restart attempt this process is (0 = first run).
    Set by ``paddle_tpu_torch.distributed.launch --max_restarts N``."""
    return int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))


# dropped into the checkpoint root by rank 0; a non-zero rank that can
# SEE it is looking at the same (shared) filesystem as rank 0
_SHARED_ROOT_MARKER = ".ckpt_root_written_by_process0"


def _rank() -> int:
    return _rank_world(None)[0]


def _root_is_shared(root: str) -> bool:
    """Whether this process's view of ``root`` is rank 0's storage. Rank
    0's answer is trivially True; other ranks answer by visibility of
    the marker rank 0 drops before every save."""
    if _rank() == 0:
        return True
    return os.path.exists(os.path.join(os.path.abspath(root),
                                       _SHARED_ROOT_MARKER))


def _prune_old_steps(root: str, step: int, keep: int) -> None:
    # only steps strictly OLDER than the current save are candidates:
    # with async_save the current step may not be committed yet
    older = sorted(s_p for s_p in checkpoint_steps(root)
                   if s_p[0] < int(step))
    n_keep_older = keep - 1  # the current step occupies one keep slot
    doomed = older[:-n_keep_older] if n_keep_older > 0 else older
    for s, p in doomed:
        shutil.rmtree(p, ignore_errors=True)


def save_checkpoint(state_dict: Dict[str, Any], root: str, step: int,
                    keep: Optional[int] = None, async_save: bool = False,
                    shared_root: Optional[bool] = None, layout=None):
    """Save ``state_dict`` under ``root/step_<step>`` (``layout`` as in
    ``save_state_dict``); with ``keep``, prune all but the newest
    ``keep`` committed steps.

    Provision the root for ``keep + 1`` checkpoints: the new step is
    written before older ones are pruned. Pruning never touches steps
    >= the current one (an in-flight async commit must survive). Who
    prunes: on a shared root rank 0 only; on per-host private roots
    every rank its own. ``shared_root`` forces a layout; None detects it
    per rank from the marker rank 0 drops in the root before the save
    (a non-zero rank returns from a save only once it is committed, by
    which time a shared root shows the marker)."""
    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep} "
                         "(keep=0 would prune nothing, silently)")
    root_abs = os.path.abspath(root)
    path = os.path.join(root_abs, f"step_{int(step)}")
    rank = _rank()
    if keep is not None and rank == 0:
        try:
            os.makedirs(root_abs, exist_ok=True)
            with open(os.path.join(root_abs, _SHARED_ROOT_MARKER),
                      "w") as f:
                f.write("presence of this file on another host means "
                        "the checkpoint root is shared storage\n")
        except OSError:
            pass
    out = save_state_dict(state_dict, path, async_save=async_save,
                          layout=layout)
    if keep is not None:
        shared = _root_is_shared(root) if shared_root is None else \
            bool(shared_root)
        if rank == 0 or not shared:
            _prune_old_steps(root, step, keep)
    return out


def checkpoint_steps(root: str):
    """[(step, path)] of committed checkpoints under ``root``."""
    root = os.path.abspath(root)
    out = []
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                out.append((int(name[5:]), os.path.join(root, name)))
            except ValueError:
                continue
    return out


def latest_checkpoint(root: str) -> Optional[str]:
    steps = checkpoint_steps(root)
    return max(steps)[1] if steps else None


def load_latest_checkpoint(state_dict: Dict[str, Any], root: str,
                           layout=None) -> int:
    """Fill ``state_dict`` from the newest ``root/step_*``; returns the
    restored step, or -1 when no checkpoint exists (fresh start — begin
    at step 0)."""
    steps = checkpoint_steps(root)
    if not steps:
        return -1
    step, path = max(steps)
    load_state_dict(state_dict, path, layout=layout)
    return step
