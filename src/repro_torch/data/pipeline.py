"""Token data pipeline (counterpart of ``repro/data/pipeline.py``).

Two sources, numpy on the host as in the reference:
 * SyntheticLM: a deterministic token stream a step (zipfian marginals,
   shift-register sequence structure, so the LM loss is learnable), used
   by the tests, the examples and the training launcher;
 * MemmapCorpus: packed uint16/uint32 token files (``np.memmap``).

:func:`make_iterator` turns their batches into tensors on one device,
or with a mesh into DTensors laid out by the batch specs
(:func:`device_put_batch`, each rank placing its own shard alone).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        v = self.vocab_size
        # zipf-ish marginals + short-range structure: x[t] depends on x[t-1]
        base = rng.zipf(1.3, size=(batch_size, self.seq_len + 1)) % v
        shift = np.roll(base, 1, axis=1) * 31
        toks = ((base + shift) % v).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class MemmapCorpus:
    path: str
    seq_len: int
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self.n_tokens = self._data.shape[0]

    def batch(self, step: int, batch_size: int) -> dict:
        span = self.seq_len + 1
        n_seq = self.n_tokens // span
        rng = np.random.default_rng(step)
        idx = rng.integers(0, n_seq, size=batch_size)
        rows = np.stack([self._data[i * span:(i + 1) * span] for i in idx])
        rows = rows.astype(np.int32)
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}


def host_batch(cfg: ModelConfig, shape: ShapeSpec, src, step: int) -> dict:
    """One step's batch as numpy arrays, as the reference builds it:
    M-RoPE models get (3, B, S) ``positions`` (0 .. S-1 on every stream),
    embedding-input models standard-normal fp32 ``embeds`` drawn from
    ``default_rng(step)`` in place of ``tokens``."""
    b = src.batch(step, shape.global_batch)
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(np.arange(shape.seq_len, dtype=np.int32),
                              (shape.global_batch, shape.seq_len))
        b["positions"] = np.broadcast_to(
            pos, (3, shape.global_batch, shape.seq_len)).copy()
    if not cfg.embed_inputs:
        rng = np.random.default_rng(step)
        b["embeds"] = rng.standard_normal(
            (shape.global_batch, shape.seq_len, cfg.d_model),
            dtype=np.float32)
        b.pop("tokens")
    return b


def to_device(cfg: ModelConfig, batch: dict, device) -> dict:
    """A host batch as tensors on ``device``; ``embeds`` cast to the
    parameter dtype by ``Tensor.to`` (round to nearest even, as numpy's
    bfloat16 cast rounds)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k == "embeds" and cfg.param_dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        out[k] = t.to(device)
    return out


def device_put_batch(batch: dict, mesh, batch_specs: dict) -> dict:
    """Place a host batch on ``mesh``: each array a DTensor laid out by its
    spec in ``batch_specs`` (replicated when it has none). A rank copies
    only its own shard to its device."""
    from repro_torch.utils.sharding import P, from_shard, placements_for
    dev = torch.device(mesh.device_type)
    coords = mesh.get_coordinate()
    out = {}
    for k, v in batch.items():
        full = v if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(v))
        pl = placements_for(mesh, batch_specs.get(k, P()))
        lo, hi = [0] * full.ndim, list(full.shape)
        for m, p in enumerate(pl):     # mesh-dim order: major to minor
            if p.is_shard():
                step = (hi[p.dim] - lo[p.dim]) // mesh.shape[m]
                lo[p.dim] += coords[m] * step
                hi[p.dim] = lo[p.dim] + step
        shard = full[tuple(slice(a, b) for a, b in zip(lo, hi))]
        out[k] = from_shard(shard.contiguous().to(dev), mesh, pl,
                            tuple(full.shape))
    return out


def make_iterator(cfg: ModelConfig, shape: ShapeSpec, source=None, seed=0,
                  device="cuda", mesh=None, batch_specs: dict | None = None):
    """Yields training batches forever, from data step 0: on ``device``,
    or with a ``mesh`` and ``batch_specs`` placed on the mesh
    (:func:`device_put_batch`)."""
    src = source or SyntheticLM(cfg.vocab_size, shape.seq_len, seed)
    step = 0
    while True:
        b = host_batch(cfg, shape, src, step)
        if mesh is not None and batch_specs is not None:
            yield device_put_batch(to_device(cfg, b, "cpu"), mesh,
                                   batch_specs)
        else:
            yield to_device(cfg, b, device)
        step += 1
