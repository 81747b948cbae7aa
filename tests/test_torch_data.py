"""The port's data pipeline against the JAX package's: synthetic and
memmapped token batches, M-RoPE positions and bf16/fp32 ``embeds``, all
bit-identical (bf16 compared through its uint16 view)."""

import dataclasses

import jax  # noqa: F401 - registers numpy's bfloat16 (ml_dtypes)
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import ShapeSpec as JShape
from repro.data import pipeline as JP
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import pipeline as P

torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """A tensor or array as its raw bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_batches_bit_identical(seed):
    j, t = JP.SyntheticLM(512, 24, seed), P.SyntheticLM(512, 24, seed)
    for step in (0, 1, 7):
        bj, bt = j.batch(step, 5), t.batch(step, 5)
        assert sorted(bj) == sorted(bt) == ["targets", "tokens"]
        for k in bj:
            assert bt[k].dtype == np.int32
            np.testing.assert_array_equal(bt[k], bj[k])
        np.testing.assert_array_equal(bt["tokens"][:, 1:],
                                      bt["targets"][:, :-1])


def test_memmap_rows_match_jax(tmp_path):
    path = str(tmp_path / "corpus.bin")
    np.arange(5000, dtype=np.uint16).tofile(path)
    j, t = JP.MemmapCorpus(path, 31), P.MemmapCorpus(path, 31)
    assert t.n_tokens == j.n_tokens == 5000
    for step in (0, 4):
        bj, bt = j.batch(step, 6), t.batch(step, 6)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k])
        assert bt["tokens"].dtype == np.int32
        # each row is a contiguous span of the file
        np.testing.assert_array_equal(np.diff(bt["tokens"], axis=1), 1)


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-vl-7b", "float32"),        # M-RoPE positions (3, B, S)
    ("musicgen-large", "float32"),     # embeds in place of tokens
    ("musicgen-large", "bfloat16"),
    ("yi-9b", "bfloat16"),
])
def test_make_iterator_matches_jax(arch, dtype):
    cj = dataclasses.replace(jax_smoke(arch), param_dtype=dtype)
    ct = dataclasses.replace(get_smoke_config(arch), param_dtype=dtype)
    itj = JP.make_iterator(cj, JShape("t", 12, 4, "train"), seed=2)
    itt = P.make_iterator(ct, ShapeSpec("t", 12, 4, "train"), seed=2,
                          device="cpu")
    for _ in range(3):
        bj, bt = next(itj), next(itt)
        assert sorted(bj) == sorted(bt)
        for k in bj:
            assert bt[k].device.type == "cpu"
            assert tuple(bt[k].shape) == tuple(bj[k].shape), k
            np.testing.assert_array_equal(_bits(bt[k]), _bits(bj[k]),
                                          err_msg=k)
    if ct.rope_kind == "mrope":
        assert bt["positions"].shape == (3, 4, 12)
    if not ct.embed_inputs:
        assert "tokens" not in bt
        assert bt["embeds"].dtype == getattr(torch, dtype)


def test_bf16_cast_rounds_to_nearest_even_as_numpy():
    """Every fp32 value the embeds can take rounds to the same bf16 bits
    by ``Tensor.to`` and numpy's bfloat16 cast, ties included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(200_000, dtype=np.float32)
    ties = (np.arange(1, 4096, dtype=np.uint32) << 16 | 0x8000)
    x = np.concatenate([x, ties.view(np.float32),
                        (ties | 0x10000).view(np.float32)])
    want = x.astype(np.dtype("bfloat16"))     # the reference's cast
    got = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), _bits(want))
