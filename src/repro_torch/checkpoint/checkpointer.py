"""Async checkpointing with atomic commit and restart discovery.

The counterpart of ``repro/checkpoint/checkpointer.py``, with its on-disk
layout, so that either package reads the other's checkpoints:

    <dir>/step_<N>/
      manifest.json       tree structure, dtypes, leaf count, step
      leaf_<i>.npy        one file a leaf, in ``jax.tree.flatten`` order
                          (dict keys sorted, sequences in order)
      COMMIT              written last; restore ignores a dir without it

A bf16 leaf (or fp8) is written as an unsigned integer view of its bits
with its true dtype name in the manifest (``"bfloat16"``), as the JAX
package writes it through ``ml_dtypes`` and as ``models/bridge.py``
carries it; it is read back through the same view, so no bit changes.

Saves run on a background thread, at most one in flight: a new save
first waits for the previous, or with ``skip_if_busy`` is skipped. Leaves
on a CUDA device are copied into pinned host buffers on a side stream of
the checkpointer's own, with ``non_blocking=True``, after an event
(``after``: by default the current stream's work so far); the writer
thread waits on the copies' event, so ``save`` itself never waits for
the device. A serve engine passes the event after which its params are
never written (``ServeEngine.snapshot``), so the copies do not queue
behind its decode rounds.

Crash safety: every file lands through a ``.part`` file and
``os.replace``, and the step directory is built as ``step_<N>.tmp`` and
renamed into place only after its COMMIT marker exists, so a writer
killed at any point leaves the previous committed snapshot and at most a
``.tmp`` directory that restore ignores. A background failure is kept and
raised by the next ``wait()`` or ``save()``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.utils import sharding as shd

#: dtypes numpy cannot hold, written as an unsigned view of their bits
#: under their own name (the JAX package's ``_VIEW``): torch dtype ->
#: (name, signed torch view, unsigned numpy view, signed numpy view)
_VIEW = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16, np.int16),
         torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8, np.uint8,
                               np.int8),
         torch.float8_e5m2: ("float8_e5m2", torch.int8, np.uint8, np.int8)}
_BY_NAME = {v[0]: dt for dt, v in _VIEW.items()}


def flatten(tree) -> tuple:
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s order: dict keys
    sorted, lists and tuples in order. ``treedef`` is ``jax``'s
    ``str(treedef)`` of the same structure (``PyTreeDef({'a': *})``)."""
    leaves: list = []

    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(x) for x in t)
            if isinstance(t, list):
                return f"[{inner}]"
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        leaves.append(t)
        return "*"
    return leaves, f"PyTreeDef({walk(tree)})"


def unflatten(like, leaves: list):
    """``like``'s structure with ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(like)


def _encode(t: torch.Tensor) -> tuple:
    """A host tensor as ``(numpy array, dtype name)``."""
    if t.dtype in _VIEW:
        name, as_int, unsigned, _ = _VIEW[t.dtype]
        return t.view(as_int).numpy().view(unsigned), name
    arr = t.numpy()
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, name: str | None) -> torch.Tensor:
    """A loaded leaf as a CPU tensor of its recorded dtype (a 0-d leaf,
    such as a train state's step, stays 0-d)."""
    arr = np.asarray(arr, order="C")
    if name in _BY_NAME:
        dt = _BY_NAME[name]
        return torch.from_numpy(arr.view(_VIEW[dt][3])).view(dt)
    return torch.from_numpy(arr)


class Checkpointer:
    """Step snapshots of a tree of tensors under ``directory``, keeping
    the newest ``keep``."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._stream = None        # side stream of the device copies
        self._pinned: dict = {}    # leaf index -> reused pinned buffer

    # -- save ----------------------------------------------------------------
    def busy(self) -> bool:
        """True while a background save is still writing."""
        return self._thread is not None and self._thread.is_alive()

    def save(self, step: int, tree, *, block: bool = False,
             skip_if_busy: bool = False, after=None) -> bool:
        """Snapshot ``tree`` at ``step``; returns True iff a save started.

        At most one write is in flight: a new save first waits for the
        previous. ``skip_if_busy=True`` turns that wait into a skip (the
        serving path snapshots opportunistically and must never stall a
        decode round on disk); a skipped save returns False. A finished
        background write is joined either way, so its errors surface
        here. ``after`` is the ``torch.cuda.Event`` the device copies
        wait for (default: the current stream's work so far).

        A tree of DTensors (a sharded engine's or train state's) is saved
        as the reference saves its sharded arrays, whole: every rank of
        the mesh calls ``save``; with ``skip_if_busy`` the ranks first
        agree (an all-reduce of the busy flags: the writer's decides),
        then each leaf is gathered whole (``sharding.replicated``) and the
        mesh's first rank writes it; the others return True at once.
        """
        leaves, treedef = flatten(tree)
        mesh = next((t.device_mesh for t in leaves if shd.is_dtensor(t)),
                    None)
        if mesh is not None:
            # every rank of the mesh takes part: the skip is agreed on
            # before any gather, so no rank gathers while another skips
            if skip_if_busy and _on_any_rank(mesh, self.busy()):
                return False
            leaves = [shd.replicated(t) if shd.is_dtensor(t) else t
                      for t in leaves]
            after = None          # the gathers are the current stream's
            if any(mesh.get_coordinate()):
                return True       # the mesh's first rank writes
        elif skip_if_busy and self.busy():
            return False
        self.wait()
        host, done = self._to_host(leaves, after)
        self._thread = threading.Thread(
            target=self._guarded_write, args=(step, host, treedef, done),
            daemon=True)
        self._thread.start()
        if block:
            self.wait()
        return True

    def _to_host(self, leaves: list, after) -> tuple:
        """Host copies of ``leaves`` and the event the CUDA ones complete
        at (None when no leaf is on a CUDA device)."""
        host, done = [], None
        for i, leaf in enumerate(leaves):
            if not isinstance(leaf, torch.Tensor):
                host.append(torch.from_numpy(np.array(leaf)))
                continue
            t = leaf.detach()
            if t.device.type != "cuda":
                host.append(t.clone())
                continue
            if done is None:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(t.device)
                if after is None:
                    self._stream.wait_stream(
                        torch.cuda.current_stream(t.device))
                else:
                    self._stream.wait_event(after)
                done = torch.cuda.Event()
            buf = self._pinned.get(i)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self._pinned[i] = torch.empty(
                    t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(self._stream):
                buf.copy_(t, non_blocking=True)
            t.record_stream(self._stream)
            host.append(buf)
        if done is not None:
            done.record(self._stream)
        return host, done

    def _guarded_write(self, step: int, leaves, treedef: str, done):
        """Run ``_write`` capturing any failure for the next ``wait()``."""
        try:
            if done is not None:
                done.synchronize()
            self._write(step, leaves, treedef)
        except BaseException as e:          # noqa: B036 - raised in wait
            self._error = e

    @staticmethod
    def _put(path: str, writer) -> None:
        """Write one file atomically: temp in the same dir + os.replace."""
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            writer(f)
        os.replace(tmp, path)

    def _write(self, step: int, leaves, treedef: str):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        dtypes = []
        for i, leaf in enumerate(leaves):
            enc, name = _encode(leaf)
            dtypes.append(name)
            self._put(os.path.join(tmp, f"leaf_{i}.npy"),
                      lambda f, a=enc: np.save(f, a))
        manifest = {"step": step, "n_leaves": len(leaves),
                    "dtypes": dtypes, "treedef": treedef}
        self._put(os.path.join(tmp, "manifest.json"),
                  lambda f: f.write(json.dumps(manifest).encode()))
        # COMMIT last: restore trusts only directories that carry it, so
        # a crash anywhere above leaves a .tmp dir all_steps() ignores
        self._put(os.path.join(tmp, "COMMIT"), lambda f: f.write(b"ok"))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()

    def wait(self):
        """Join the background write; raise its failure, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") \
                from err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list:
        """Committed steps, ascending."""
        out = []
        for name in sorted(os.listdir(self.dir)):
            p = os.path.join(self.dir, name)
            # exact step_<digits> only: a crash can leave step_N.tmp
            # behind (even with COMMIT inside, if it died between the
            # marker write and the directory rename), never loadable
            if not name.startswith("step_"):
                continue
            suffix = name[len("step_"):]
            if not suffix.isdigit():
                continue
            if os.path.exists(os.path.join(p, "COMMIT")):
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree, mesh=None, spec_tree=None):
        """Restore into the structure of ``like_tree``: each leaf on the
        device of ``like_tree``'s leaf (a tensor's), in its recorded
        dtype; with ``mesh`` and ``spec_tree`` (a matching tree of specs,
        ``sharding.P``) each leaf is placed on the mesh by its spec, each
        rank keeping its shard (the reference's elastic re-shard: a
        snapshot restores onto any mesh)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        like, _ = flatten(like_tree)
        n = len(like)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", [None] * n)
        loaded = []
        for i, ref in enumerate(like):
            t = _decode(np.load(os.path.join(d, f"leaf_{i}.npy")), dtypes[i])
            if isinstance(ref, torch.Tensor):
                t = t.to(ref.device)
            loaded.append(t)
        if mesh is not None and spec_tree is not None:
            specs = _dict_leaves(spec_tree)
            loaded = [shd.distribute_leaf(t.to(mesh.device_type), mesh, sp)
                      for t, sp in zip(loaded, specs)]
        return unflatten(like_tree, loaded)

    def restore_latest(self, like_tree, mesh=None, spec_tree=None):
        s = self.latest_step()
        if s is None:
            return None, None
        return s, self.restore(s, like_tree, mesh, spec_tree)


def _dict_leaves(tree) -> list:
    """The leaves of a tree of dicts in :func:`flatten`'s order, anything
    but a dict a leaf (a spec is a tuple)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _dict_leaves(tree[k])]
    return [tree]


def _on_any_rank(mesh, flag: bool) -> bool:
    """Whether ``flag`` holds on any rank of ``mesh`` (a max all-reduce
    over each mesh dim's group)."""
    import torch.distributed as dist
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=mesh.device_type)
    for m in range(mesh.ndim):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(m))
    return bool(t.item())
