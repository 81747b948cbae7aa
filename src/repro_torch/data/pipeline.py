"""Token data pipeline (counterpart of ``repro/data/pipeline.py``).

Two sources, numpy on the host as in the reference:
 * SyntheticLM: a deterministic token stream a step (zipfian marginals,
   shift-register sequence structure, so the LM loss is learnable), used
   by the tests, the examples and the training launcher;
 * MemmapCorpus: packed uint16/uint32 token files (``np.memmap``).

:func:`make_iterator` turns their batches into tensors on one device.
Placing a batch across a mesh (the reference's ``device_put_batch``)
waits for the port's mesh (ROADMAP queue 1 item 7b).
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


def make_iterator(cfg: ModelConfig, shape: ShapeSpec, source=None, seed=0,
                  device="cuda"):
    """Yields training batches on ``device`` forever, from data step 0."""
    src = source or SyntheticLM(cfg.vocab_size, shape.seq_len, seed)
    step = 0
    while True:
        yield to_device(cfg, host_batch(cfg, shape, src, step), device)
        step += 1
