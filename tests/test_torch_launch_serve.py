"""The port's serving entry point (``repro_torch.launch.serve``) against
the JAX package's: ``generate`` streams equal JAX's on bridged fp32 params
(one engine, pipelined, and two replicas behind the routers); ``main``
refuses without a card unless ``--device cpu`` asks for the host, refuses
a mesh it cannot build, serves from an installed plan database with no online plan; the
dtype policy maps to PyTorch's matmul precision and an unknown value
raises."""

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import generate as jax_generate
from repro_torch.kernels.tuning import default_machine
from repro_torch.launch import serve as LS
from repro_torch.serve import plandb
from repro_torch.serve.planner import plan_stats

from _torch_common import bridged_params, cfg_pair

torch.set_num_threads(1)

B, S, GEN = 3, 7, 9


@pytest.fixture(scope="module")
def models():
    cj, ct = cfg_pair("float32", "yi-9b")
    pj, pt = bridged_params(cj, ct)
    prompts = np.random.default_rng(2).integers(0, ct.vocab_size, (B, S))
    return cj, ct, pj, pt, prompts


@pytest.mark.parametrize("kw", [
    dict(), dict(pipeline=2), dict(replicas=2),
    dict(replicas=2, fault_tolerant=True, pipeline=2)],
    ids=["one", "pipelined", "router", "fault_tolerant"])
def test_generate_matches_jax(models, kw):
    """fp32 greedy: the port's tokens equal JAX's, token for token."""
    cj, ct, pj, pt, prompts = models
    want = np.asarray(jax_generate(cj, pj, jax.numpy.asarray(prompts), GEN,
                                   chunk=4, **kw))
    engines = []
    got = LS.generate(ct, pt, torch.from_numpy(prompts), GEN, chunk=4,
                      device="cpu", engine_out=engines, **kw)
    assert got.shape == (B, GEN)
    assert got.tolist() == want.tolist()
    assert all(e.pipeline == kw.get("pipeline", 0) for e in engines)
    assert len(engines) == kw.get("replicas", 1)


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert LS.main(["--smoke"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_main_runs_on_the_host_when_asked(capsys):
    assert LS.main(["--arch", "xlstm-125m", "--smoke", "--batch", "2",
                    "--prompt-len", "5", "--gen", "6", "--chunk", "2",
                    "--pipeline", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 6) on host" in out and "pipeline=2" in out


def test_main_refuses_a_mesh(capsys, monkeypatch):
    """A mesh it cannot build: a bad spec, or more ranks than the world
    has (``tests/test_torch_mesh_serve.py`` serves under two ranks)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert LS.main(["--smoke", "--device", "cpu", "--mesh", "1,2"]) == 2
    assert "bad mesh spec '1,2'" in capsys.readouterr().err
    assert LS.main(["--smoke", "--device", "cpu", "--mesh",
                    "data,model=1,2"]) == 2
    assert "torchrun --nproc-per-node 2" in capsys.readouterr().err


def test_main_plans_from_an_installed_db(tmp_path, capsys):
    """A database swept at the launcher's serving point answers its plan:
    one hit, no online plan."""
    from repro_torch.configs import get_smoke_config
    batch, plen, gen = 2, 5, 33          # max_chunk min(32, gen - 1) = 32
    db = plandb.sweep(get_smoke_config("xlstm-125m"), batches=(batch,),
                      max_lens=(plen + gen,), machines=(default_machine(),),
                      tps=(1,))
    path = tmp_path / "plans.json"
    db.save(path)
    prev = plandb.installed()
    try:
        assert LS.main(["--arch", "xlstm-125m", "--smoke", "--batch",
                        str(batch), "--prompt-len", str(plen), "--gen",
                        str(gen), "--plan-db", str(path), "--device",
                        "cpu"]) == 0
        stats = plan_stats()
    finally:
        plandb.install(prev)
    assert stats["db_hits"] == 1 and stats["online_plans"] == 0
    assert "plan db:" in capsys.readouterr().out


@pytest.mark.parametrize("policy,prec", [("f32", "highest"),
                                         ("tf32", "high"),
                                         ("bf16", "medium")])
def test_dtype_policy_map(policy, prec):
    prev = torch.get_float32_matmul_precision()
    try:
        applied = LS.apply_runtime_policy({"REPRO_DTYPE_POLICY": policy})
        assert torch.get_float32_matmul_precision() == prec
        assert applied == {"dtype_policy": f"{policy} -> {prec}"}
    finally:
        torch.set_float32_matmul_precision(prev)


def test_dtype_policy_unknown_raises():
    prev = torch.get_float32_matmul_precision()
    with pytest.raises(ValueError, match="REPRO_DTYPE_POLICY"):
        LS.apply_runtime_policy({"REPRO_DTYPE_POLICY": "fp8"})
    assert torch.get_float32_matmul_precision() == prev
    assert LS.apply_runtime_policy({}) == {}
