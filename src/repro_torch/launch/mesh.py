"""Device mesh builders on ``torch.distributed``.

The counterpart of ``repro/launch/mesh.py``. Functions, not module
constants, so importing this module starts no process group. Each mesh
is an ``init_device_mesh`` over the default process group, one rank a
device: the single-pod production mesh is 16x16 = 256 ranks ``("data",
"model")``, the multi-pod mesh 2x16x16 = 512 ranks ``("pod", "data",
"model")`` (``"pod"`` a pure extra data-parallel axis).

The mesh's sizes must multiply to the world size. Several ranks come from
a launcher (``torchrun --nproc-per-node N``, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address); a mesh of
size 1 with no process group starts a world of one itself, so a single
process serves under ``--mesh data,model=1,1``.

The device type is the card's (``"cuda"``) unless the caller asks for
``"cpu"``. The backend is NCCL on the card and gloo on the host;
``backend=`` names another explicitly: gloo on CUDA tensors runs two
ranks on one card, which NCCL refuses (its collectives are staged
through the host, and a gloo group cannot be captured in a CUDA graph).
A rank's device is ``cuda:{local_rank % device_count}``.

``fake=True`` builds the mesh over a fake process group
(``torch.testing._internal.distributed.fake_pg``): one process stands
for rank 0 of a world of the mesh's size, its collectives do nothing,
and with meta tensors DTensor lowers a step of any size without a card
(``launch/dryrun.py``). The device type stays the card's by default, so
DTensor picks the collectives NCCL would run; no card is needed for it.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _start_world(n: int, what: str, device_type: str,
                 backend: str | None) -> None:
    """Make sure the default process group exists and has ``n`` ranks."""
    if dist.is_initialized():
        have = dist.get_world_size()
    elif n == 1 and "WORLD_SIZE" not in os.environ:
        dist.init_process_group(backend or _default_backend(device_type),
                                store=dist.HashStore(), rank=0,
                                world_size=1)
        have = 1
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend or _default_backend(device_type))
        have = dist.get_world_size()
    else:
        have = 1
    if have != n:
        raise RuntimeError(
            f"{what} needs {n} ranks, the world has {have}; run under "
            f"torchrun --nproc-per-node {n}")


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}``, or the
    host."""
    if device_type != "cuda":
        return torch.device(device_type)
    local_rank = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def start_fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks (this
    process rank 0), unless such a group is already up; raises if a real
    group, or a fake one of another size, is."""
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake" or dist.get_world_size() != n:
            raise RuntimeError(
                f"a fake world of {n} ranks needs no process group, this "
                f"process has a {backend!r} one of "
                f"{dist.get_world_size()} ranks")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _mesh(shape: tuple, axes: tuple, what: str, device_type: str | None,
          backend: str | None, fake: bool = False):
    from torch.distributed.device_mesh import init_device_mesh
    device_type = device_type or "cuda"
    if fake:
        start_fake_world(math.prod(shape))
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; pass "
                           "device_type='cpu' for a mesh on the host")
    _start_world(math.prod(shape), what, device_type, backend)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None,
                         backend: str | None = None, fake: bool = False):
    """The 16x16 ``("data", "model")`` mesh, or 2x16x16 with ``"pod"``;
    ``fake=True`` over a fake world of 256 or 512 ranks
    (:func:`start_fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "the production mesh", device_type, backend,
                 fake)


def make_test_mesh(shape=(1, 1), axes=("data", "model"), *,
                   device_type: str | None = None,
                   backend: str | None = None, fake: bool = False):
    """A small mesh over the world's ranks (tests, smoke runs); ``fake``
    as in :func:`make_production_mesh`."""
    return _mesh(tuple(shape), tuple(axes), f"mesh {tuple(shape)}",
                 device_type, backend, fake)


def parse_mesh_spec(spec: str) -> tuple:
    """``"data,model=1,2"`` -> ``(("data", "model"), (1, 2))``."""
    try:
        axes_s, sizes_s = spec.split("=")
        axes = tuple(a.strip() for a in axes_s.split(","))
        shape = tuple(int(s) for s in sizes_s.split(","))
    except ValueError as e:
        raise ValueError(
            f"bad mesh spec {spec!r}; expected 'axis,axis=size,size' "
            "like 'data,model=1,2'") from e
    if len(axes) != len(shape) or not axes:
        raise ValueError(
            f"mesh spec {spec!r}: {len(axes)} axes vs {len(shape)} sizes")
    return axes, shape


def make_serve_mesh(spec: str | None, *, device_type: str | None = None,
                    backend: str | None = None):
    """A serve mesh from a CLI spec ``"axes=sizes"``, e.g.
    ``"data,model=1,2"`` -> a (1, 2) mesh on ``("data", "model")``.

    ``None`` or ``""`` returns ``None``, the engines' single-device path.
    The sizes must multiply to the world size (``torchrun
    --nproc-per-node N``); a spec of size 1 starts a world of one.
    """
    if not spec:
        return None
    axes, shape = parse_mesh_spec(spec)
    return _mesh(shape, axes, f"mesh {spec!r}", device_type, backend)
