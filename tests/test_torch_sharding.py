"""The port's sharding spec builders against the JAX package's.

Pure spec work, no process group: ``spec_for`` entry by entry with JAX's
``PartitionSpec``; every config's parameter, cache, paged-cache, batch
and train-state spec trees under every rules table at four mesh shapes;
the train-state and batch shape trees; the serve mesh spec grammar; the
planner's keys under a mesh. DTensor local shapes on the 256- and
512-rank production meshes run in a subprocess over a fake process
group (a process group is process-wide state).
"""

import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
from hypothesis import given, strategies as st

from repro.configs import ARCH_IDS, get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import SHAPES as JSHAPES
from repro.models import model as JM
from repro.optim.adamw import OptConfig as JOptConfig
from repro.serve import pages as JPG
from repro.serve import planner as JPL
from repro.train import step as JST
from repro.utils import sharding as JS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.optim.adamw import OptConfig
from repro_torch.serve import pages as PG
from repro_torch.serve import planner as PL
from repro_torch.train import step as ST
from repro_torch.utils import sharding as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RULES = ("TRAIN_RULES", "SERVE_RULES", "SERVE_ENGINE_RULES",
         "SERVE_ENGINE_FSDP_RULES", "SERVE_FSDP_RULES",
         "SERVE_FSDP_GATHER_RULES")
MESHES = ({"data": 1, "model": 2}, {"data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})
TREES = ("params", "cache", "paged", "batch", "train_fp32", "train_int8")


def _flat(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, a spec (any tuple) a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _same_specs(jtree, ttree, what):
    jflat, tflat = list(_flat(jtree)), list(_flat(ttree))
    assert [p for p, _ in jflat] == [p for p, _ in tflat], what
    for (path, js), (_, ts) in zip(jflat, tflat):
        assert isinstance(ts, S.P), (what, path)
        assert tuple(ts) == tuple(js), (what, path, js, ts)


def test_rules_tables_equal_jax():
    for name in RULES:
        assert getattr(S, name) == getattr(JS, name), name


@given(st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 16, 32, 64, 128, 256,
                                 688, 1536, 4096]),
                min_size=1, max_size=4),
       st.lists(st.sampled_from(["embed", "mlp", "qheads", "kvheads",
                                 "vocab", "expert", "batch", None]),
                min_size=1, max_size=4),
       st.sampled_from(range(len(MESHES))),
       st.sampled_from(RULES))
def test_spec_for_equals_jax_and_keeps_its_properties(shape, axes, mesh,
                                                      rules):
    """Divisibility and no mesh axis twice (the reference's property
    test), and JAX's spec entry for entry."""
    sizes = MESHES[mesh]
    axes = (axes + [None] * 4)[:len(shape)]
    spec = S.spec_for(tuple(shape), tuple(axes), getattr(S, rules), sizes)
    assert tuple(spec) == tuple(JS.spec_for(tuple(shape), tuple(axes),
                                            getattr(JS, rules), sizes))
    used = []
    for dim, part in zip(shape, spec):
        if part is None:
            continue
        parts = part if isinstance(part, tuple) else (part,)
        prod = 1
        for p in parts:
            assert p not in used, "mesh axis used twice"
            used.append(p)
            prod *= sizes[p]
        assert dim % prod == 0, "non-divisible sharding"


def _trees(kind, cfg, jcfg, rules, jrules, sizes):
    """(JAX tree, port tree) of one spec tree kind."""
    if kind == "params":
        return (JM.param_pspecs(jcfg, jrules, sizes),
                M.param_pspecs(cfg, rules, sizes))
    if kind == "cache":
        return (JM.cache_pspecs(jcfg, jrules, sizes, 128, 4096),
                M.cache_pspecs(cfg, rules, sizes, 128, 4096))
    if kind == "paged":
        return (JPG.paged_cache_pspecs(jcfg, jrules, sizes, 8, 257, 16),
                PG.paged_cache_pspecs(cfg, rules, sizes, 8, 257, 16))
    if kind == "batch":
        out_j, out_t = {}, {}
        for name in SHAPES:
            out_j[name] = JST.batch_pspecs(
                jcfg, JST.batch_shapes(jcfg, JSHAPES[name]), jrules, sizes)
            out_t[name] = ST.batch_pspecs(
                cfg, ST.batch_shapes(cfg, SHAPES[name]), rules, sizes)
        return out_j, out_t
    md = "int8" if kind == "train_int8" else "float32"
    return (JST.train_state_pspecs(jcfg, jrules, sizes,
                                   JOptConfig(moments_dtype=md)),
            ST.train_state_pspecs(cfg, rules, sizes,
                                  OptConfig(moments_dtype=md)))


@pytest.mark.parametrize("kind", TREES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_jax(arch, kind):
    """Every config's spec tree of ``kind`` equals JAX's under each rules
    table at mesh sizes (1,2), (2,2), (16,16) and (2,16,16)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in RULES:
        for sizes in MESHES:
            jt, tt = _trees(kind, cfg, jcfg, getattr(S, name),
                            getattr(JS, name), sizes)
            _same_specs(jt, tt, (arch, kind, name, sizes))


def test_grok_experts_fall_back_to_ffn_sharding():
    specs = M.param_pspecs(get_config("grok-1-314b"), S.TRAIN_RULES,
                           {"data": 16, "model": 16})
    moe = specs["scan"]["0"]["ffn"]["w_up"]   # (stack, E=8, d, ffe)
    # 8 experts do not divide model=16: the expert dim stays unsharded
    # and the expert FFN dim takes the model axis
    assert moe[1] is None and moe[3] == "model"


def test_qwen3_experts_sharded():
    specs = M.param_pspecs(get_config("qwen3-moe-235b-a22b"), S.TRAIN_RULES,
                           {"data": 16, "model": 16})
    assert specs["scan"]["0"]["ffn"]["w_up"][1] == "model"   # E=128


def _jax_dtype(t):
    return {"bfloat16": "bfloat16", "float32": "float32", "int8": "int8",
            "int32": "int32"}[str(t.dtype).replace("torch.", "")]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_and_batch_shapes_equal_jax(arch):
    """``train_state_shapes`` (fp32 and int8 moments) and every shape's
    ``batch_shapes``: meta tensors of JAX's shapes and dtypes."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    pairs = [(JST.train_state_shapes(jcfg, JOptConfig(moments_dtype=md)),
              ST.train_state_shapes(cfg, OptConfig(moments_dtype=md)))
             for md in ("float32", "int8")]
    pairs += [(JST.batch_shapes(jcfg, JSHAPES[n], with_targets=w),
               ST.batch_shapes(cfg, SHAPES[n], with_targets=w))
              for n in SHAPES for w in (True, False)]
    for jt, tt in pairs:
        jflat = jax.tree_util.tree_flatten_with_path(jt)[0]
        tflat = list(_flat(tt))
        assert [tuple(k.key for k in p) for p, _ in jflat] == \
            [p for p, _ in tflat]
        for (_, j), (path, t) in zip(jflat, tflat):
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(j.shape), path
            assert _jax_dtype(t) == str(j.dtype), path


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 16, 16))
    pl = S.placements_for(mesh, S.P(("pod", "data"), None, "model"))
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert S.placements_for(mesh, S.P(None, None)) == (Replicate(),) * 3
    # a mesh dim of size 1 holds the whole dim: Replicate
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                shape=(1, 2))
    assert S.placements_for(one, S.P("data", "model")) == (Replicate(),
                                                            Shard(1))
    with pytest.raises(ValueError, match="axis order"):
        S.placements_for(mesh, S.P(("data", "pod")))


def test_sc_is_identity_without_a_mesh():
    import torch
    x = torch.ones(2, 3)
    assert S.sc(x, "batch", None) is x
    with S.use_mesh_rules(None, S.SERVE_ENGINE_RULES):
        assert S.sc(x, "batch", None) is x
        assert S.current_mesh() is None


def test_serve_mesh_spec_grammar_and_errors(monkeypatch):
    assert LM.make_serve_mesh("") is None and LM.make_serve_mesh(None) is None
    assert LM.parse_mesh_spec("data,model=1,2") == (("data", "model"), (1, 2))
    assert LM.parse_mesh_spec(" pod , data,model=2,1,4") == \
        (("pod", "data", "model"), (2, 1, 4))
    with pytest.raises(ValueError, match="bad mesh spec"):
        LM.make_serve_mesh("data,model")
    with pytest.raises(ValueError, match="bad mesh spec"):
        LM.make_serve_mesh("data,model=1,x")
    with pytest.raises(ValueError, match="2 axes vs 3 sizes"):
        LM.make_serve_mesh("data,model=1,2,3")
    # more ranks than the world has: a RuntimeError naming the launcher
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        LM.make_serve_mesh("data,model=1,2", device_type="cpu")


def _fake_mesh(data=1, model=2):
    """A mesh's names and sizes, all the planner reads of it."""
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(data, model))


def test_plan_keys_fold_the_mesh():
    """A sharded plan never serves an unsharded admission and the other
    way round; a (1, tp) mesh and the meshless ``tp=`` plan share one
    key; another TP degree is a third entry (the reference's
    ``test_plan_cache_keys_on_sharding``)."""
    cfg = get_smoke_config("yi-9b")
    PL.clear_plan_cache()
    p0 = PL.plan_chunk_size(cfg, 2, 32)
    ps = PL.plan_chunk_size(cfg, 2, 32, mesh=_fake_mesh())
    assert p0.tp == 1 and ps.tp == 2 and ps is not p0
    assert PL.plan_chunk_size(cfg, 2, 32) is p0
    assert PL.plan_chunk_size(cfg, 2, 32, mesh=_fake_mesh()) is ps
    assert PL.plan_chunk_size(cfg, 2, 32, tp=2) is ps
    p4 = PL.plan_chunk_size(cfg, 2, 32, mesh=_fake_mesh(model=4))
    assert p4.tp == 4 and p4 is not ps
    JPL.clear_plan_cache()
    jp = JPL.plan_chunk_size(jax_smoke_config("yi-9b"), 2, 32,
                             machine=ps.machine,
                             mesh=types.SimpleNamespace(
                                 axis_names=("data", "model"),
                                 devices=types.SimpleNamespace(
                                     shape=(1, 2))))
    assert jp.tp == ps.tp and jp.chunk == ps.chunk


def test_local_heads_set_the_split_count():
    """At TP=2 the decode kernels run on a shard's KV heads: the tuner
    prices half the thread blocks a split on ``h100``, and the plan's
    bound is the tuner's at the local heads."""
    from repro_torch.kernels.attention import decode as D
    from repro_torch.serve import kv_traffic as KT
    cfg = get_config("yi-9b")
    assert D.default_splits(8, 2, 64) == 2 * D.default_splits(8, 4, 64)
    _, b1 = KT.bounded_decode_plan(cfg, 8, 2048, 1000, "h100")
    plan2, b2 = KT.bounded_decode_plan(cfg, 8, 2048, 1000, "h100", tp=2)
    from repro_torch.kernels import tuning
    want = tuning.decode_tiles("h100", skv=1000, dh=128, h=16, hkv=2,
                               batch=8, dtype=cfg.param_dtype)
    assert plan2 == want and b1 > 0 and b2 > 0


FAKE_WORLD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as M
    from repro_torch.utils import sharding as S
    multi = {multi}
    n = 512 if multi else 256
    dist.init_process_group("fake", store=FakeStore(), rank={rank},
                            world_size=n)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    sizes = S.mesh_axis_sizes(mesh)
    cfg = get_config("yi-9b")
    out = []
    for name in ("TRAIN_RULES", "SERVE_ENGINE_RULES"):
        specs = M.param_pspecs(cfg, getattr(S, name), sizes)
        for path, (shape, dtype) in M._walk(M.param_shapes(cfg)):
            spec = specs
            for k in path:
                spec = spec[k]
            t = S.zeros(shape, dtype, mesh, spec, "meta")
            want = list(shape)
            for d, part in enumerate(spec):
                for ax in (part if isinstance(part, tuple) else
                           (part,) if part else ()):
                    want[d] //= sizes[ax]
            out.append([name, "/".join(path), list(t.shape),
                        list(t.to_local().shape), want])
    print(json.dumps({{"sizes": sizes, "leaves": out}}))
""")


@pytest.mark.parametrize("multi_pod,rank", [(False, 0), (False, 255),
                                            (True, 0), (True, 511)])
def test_production_mesh_local_shapes(multi_pod, rank):
    """``make_production_mesh`` on a fake process group of 256 or 512
    ranks; yi-9b's parameter DTensors (``sharding.zeros`` on meta) hold
    the global shape and, on this rank, the shape the spec divides it
    to."""
    import json
    code = FAKE_WORLD.format(src=os.path.join(REPO, "src"),
                             multi=multi_pod, rank=rank)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["sizes"] == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                            else {"data": 16, "model": 16})
    assert got["leaves"]
    for name, path, glob, loc, want in got["leaves"]:
        assert loc == want, (name, path, glob, loc)
    shapes = dict((p, s) for _, p, s, _, _ in got["leaves"])
    assert shapes["tok_embed"] == [64000, 4096]
    assert np.prod(shapes["scan/0/ffn/w_up"]) == 48 * 4096 * 11008
