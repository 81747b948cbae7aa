"""The port's entry points (``examples/torch/*.py``) against the JAX
package's (``examples/*.py``), on the CPU.

Held: every script imports without JAX or the JAX package;
``compare_arch``'s table agrees with the reference's on each shared
machine's write-allocate mode and ratio, the paper's ordering and the
matrix products' FLOPs, and its stored bytes differ by the named
differences alone; ``quickstart``'s triad trace has the reference's
FLOPs and HBM bytes on ``tpu_v5e``; ``analyze_arch``'s train step has
the reference's matrix-product FLOPs and prices compute at the H100's
bf16 peak; ``serve_lm`` serves its 144 tokens alone, behind the router
and under a two-rank mesh; ``train_lm`` hands the launcher the
reference's argv plus ``--device``; without a card the scripts that run
anything exit 2.
"""

import importlib.util
import math
import os
import re
import signal
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core import portmodel as JPM
from repro.core import trace as JT
from repro.core.machine import MACHINES as JMACHINES
from repro.optim.adamw import OptConfig as JOptConfig
from repro.train import step as jstep
from repro_torch.core import baseline, portmodel, wa
from repro_torch.core.machine import get_machine

from _torch_common import matmul_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("compare_arch", "quickstart", "analyze_arch", "serve_lm",
            "train_lm")
CPUS = ("zen4", "golden_cove", "neoverse_v2")
DOT_RTOL = 0.01
MESH_TIME_LIMIT = 180


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name: str):
    """``examples/torch/<name>.py`` as a module."""
    return _load(os.path.join(REPO, "examples", "torch", f"{name}.py"),
                 f"torch_example_{name}")


def reference(name: str):
    """``examples/<name>.py`` (the JAX package's) as a module."""
    return _load(os.path.join(REPO, "examples", f"{name}.py"),
                 f"jax_example_{name}")


# --- (a) imports ------------------------------------------------------------

@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax_and_no_repro(name):
    path = os.path.join(REPO, "examples", "torch", f"{name}.py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ex', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", ("quickstart", "serve_lm", "train_lm"))
def test_without_a_card_the_runners_exit_2(name, monkeypatch, capsys):
    """No quiet fall-back to the host: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port(name).main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("spec", ("data,model=1", "data,model=1,2"))
def test_serve_lm_refuses_a_mesh_it_cannot_make(spec, capsys):
    """A malformed spec, or one the world's single rank cannot fill,
    exits 2 with the reason (as ``launch.serve`` does)."""
    assert port("serve_lm").main(["--smoke", "--device", "cpu", "--mesh",
                                  spec]) == 2
    assert "mesh" in capsys.readouterr().err


# --- (b) compare_arch -------------------------------------------------------

#: where the port's stored bytes differ from the reference's, and why, at
#: (seq, d_model): one plane is seq x d_model f32. Both scans count a loop
#: body's stores once. The reference's store scan reads fusion outputs
#: and dynamic-update-slices; the ATen trace stores every op's output.
STORE_DIFFERENCES = {
    # XLA splits the softmax into an exp and a divide fusion; ATen runs
    # one _softmax
    "softmax as two fusions": lambda s, d: s * d * 4,
    # XLA's row max and row sum, each a reduce-window of 32 lanes and a
    # reduce, store their partial and final rows
    "softmax row reductions": lambda s, d: 2 * (s * 4 + s * math.ceil(
        d / 32) * 4),
    # XLA's dot is no fusion, so its scan skips c @ w1's output; ATen's
    # mm stores it (the second dot is the port's in-place addmm_, the
    # reference's residual add fusion: one store each)
    "dot output": lambda s, d: -s * d * 4,
    # the carry: XLA copies x into the loop with a copy, which its scan
    # skips; the port's clone stores
    "loop carry": lambda s, d: -s * d * 4,
    # XLA's dynamic-update-slice is counted by its update (one plane)
    # and again as the whole 4-slot output of its fusion; the port
    # writes the one plane
    "cache write": lambda s, d: 4 * s * d * 4,
    # the while loop's s32 counter add and its pred compare
    "loop counter": lambda s, d: 4 + 1,
}
SIZES = ((128, 256, 4), (7, 60, 3))


@pytest.fixture(scope="module")
def compare_pair():
    """Each size's reference HLO and port trace, lowered once."""
    J, T = reference("compare_arch"), port("compare_arch")
    return J, T, {size: (J.workload_hlo(*size), T.workload_trace(*size))
                  for size in SIZES}


@pytest.mark.parametrize("nt", (False, True), ids=("std", "nt"))
@pytest.mark.parametrize("size", SIZES, ids=("128x256x4", "7x60x3"))
def test_compare_arch_agrees_with_the_reference(compare_pair, size, nt):
    J, T, lowered = compare_pair
    hlo, tr = lowered[size]
    jrows = {n: (r, w) for n, r, w in J.compare_table(hlo, nt_stores=nt,
                                                      backend="tp")}
    trows = {n: (r, w) for n, r, w in T.compare_table(tr, nt_stores=nt,
                                                      backend="tp")}
    assert tuple(trows) == T.DEFAULT_MACHINES
    shared = set(jrows) & set(trows)
    assert shared == set(CPUS)
    for n in shared:
        (_, jw), (_, tw) = jrows[n], trows[n]
        assert tw["wa_mode"] == jw["wa_mode"], n
        assert tw["wa_ratio"] == pytest.approx(jw["wa_ratio"], rel=1e-12), n
        assert tw["rmw_read_bytes"] == jw["rmw_read_bytes"] == 0.0
    s, d, _ = size
    diff = sum(f(s, d) for f in STORE_DIFFERENCES.values())
    for n in trows:
        assert trows[n][1]["stored_bytes"] == 6 * s * d * 4
    assert jrows["zen4"][1]["stored_bytes"] - \
        trows["zen4"][1]["stored_bytes"] == diff
    # the ordering holds in both packages (it is checked with standard
    # stores; with NT stores Zen 4 evades fully)
    if not nt:
        ok, *_ = T.ordering(list((n, r, w) for n, (r, w) in trows.items()))
        assert ok
        t = {n: w["traffic_bytes"] for n, (_, w) in jrows.items()}
        assert t["neoverse_v2"] <= t["golden_cove"] <= t["zen4"]
    want = matmul_flops(JT.lower_text(hlo).entry)
    assert want > 0
    assert matmul_flops(tr.entry) == pytest.approx(want, rel=DOT_RTOL)


@pytest.mark.parametrize("argv", ([], ["--seq", "7", "--d-model", "60"]),
                         ids=("default", "probe"))
def test_compare_arch_prints_every_row_and_the_ordering(argv, capsys):
    T = port("compare_arch")
    assert T.main(argv) == 0
    out = capsys.readouterr().out
    for m in T.DEFAULT_MACHINES:
        assert re.search(rf"^{m}\s", out, re.M), m
    assert "WA ordering Grace <= SPR <= Zen4 (no NT stores): OK" in out


# --- (c) quickstart ---------------------------------------------------------

def test_quickstart_triad_prices_as_the_reference():
    n = 4096
    hlo = jax.jit(lambda b, c: b + 2.5 * c).lower(
        jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32)).compile()
    jrep = JPM.analyze(hlo.as_text(), JMACHINES["tpu_v5e"])
    Q = port("quickstart")
    rep = portmodel.analyze(Q.triad_trace(n), "tpu_v5e")
    assert (rep.flops, rep.bytes_hbm) == (jrep.flops, jrep.bytes_hbm)
    assert rep.bytes_hbm == 3 * 4 * n
    # the naive baseline's counts are XLA's cost_analysis'
    meta = [torch.empty(n, device="meta") for _ in range(2)]
    counts = baseline.step_counts(Q.triad, *meta)
    ca = baseline.normalize_cost_analysis(hlo.cost_analysis())
    assert counts["flops"] == ca["flops"]
    assert counts["bytes accessed"] == ca["bytes accessed"]
    # outside a lowering the triad is the plain function
    b, c = torch.randn(n), torch.randn(n)
    assert torch.equal(Q.triad(b, c), b + 2.5 * c)


# --- (d) analyze_arch -------------------------------------------------------

def test_analyze_arch_matches_the_reference_train_step(capsys):
    arch, seq, batch = "yi-9b", 32, 2
    cfg = jax_smoke_config(arch)
    fn = jstep.make_train_step(cfg, JOptConfig(), 1)
    hlo = jax.jit(fn).lower(
        jstep.train_state_shapes(cfg),
        jstep.batch_shapes(cfg, JShapeSpec("example", seq, batch,
                                           "train"))).compile().as_text()
    want = matmul_flops(JT.lower_text(hlo).entry)
    A = port("analyze_arch")
    tr = A.lower_train_step(arch, seq, batch)
    assert want > 0
    assert matmul_flops(tr.entry) == pytest.approx(want, rel=DOT_RTOL)
    h100 = get_machine("h100")
    rep = portmodel.analyze(tr, h100)
    assert rep.unknown_ops == 0
    terms = A.roofline_terms(rep, wa.analyze_trace_stores(tr), h100)
    assert h100.chip.bf16_flops == pytest.approx(989e12, rel=0.01)
    assert terms["compute"] == rep.flops / h100.chip.bf16_flops
    assert terms["memory"] > 0 and terms["collective"] == 0.0
    assert A.main(["--arch", arch, "--seq", str(seq), "--batch",
                   str(batch)]) == 0
    out = capsys.readouterr().out
    printed = float(re.search(r"T_compute\s+:\s+(\S+) us", out).group(1))
    assert printed == pytest.approx(terms["compute"] * 1e6, abs=0.05)
    assert re.search(r"unknown ops\s+: 0$", out, re.M)


# --- (e) serve_lm -----------------------------------------------------------

SERVED = re.compile(r"served 6 requests on 2 slots: 144 tokens in \S+s — "
                    r"chunk=\d+, \d+ decode dispatches, \d+ prefills(.*)")


def _streams(out: str) -> list:
    return re.findall(r"^  (req\d): (\d+) tokens, first 8 = (.*)$", out,
                      re.M)


@pytest.fixture(scope="module")
def served_alone():
    """``serve_lm --smoke --device cpu``'s output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port("serve_lm").main(["--smoke", "--device", "cpu"]) == 0
    return buf.getvalue()


def test_serve_lm_serves_144_tokens(served_alone):
    assert SERVED.search(served_alone).group(1) == ""
    got = _streams(served_alone)
    assert [(r, int(n)) for r, n, _ in got] == [
        (f"req{i}", 16 + 8 * (i % 3)) for i in range(6)]


def test_serve_lm_replicas_serve_144_tokens(served_alone, capsys):
    assert port("serve_lm").main(["--smoke", "--device", "cpu",
                                  "--replicas", "2"]) == 0
    out = capsys.readouterr().out
    assert SERVED.search(out).group(1) == ", 2 replicas"
    # the requests' streams are the engine's seeded ones wherever they run
    assert _streams(out) == _streams(served_alone)


def test_serve_lm_mesh_under_torchrun_serves_144_tokens(served_alone):
    """The README's ``torchrun`` line at two gloo ranks on the host: rank
    0 alone prints, at tp=2, the unsharded engine's tokens."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2",
           os.path.join(REPO, "examples", "torch", "serve_lm.py"),
           "--smoke", "--device", "cpu", "--mesh", "data,model=1,2"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=MESH_TIME_LIMIT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"serve_lm under torchrun ran past {MESH_TIME_LIMIT} s")
    assert proc.returncode == 0, err[-4000:]
    assert SERVED.search(out).group(1) == ", tp=2"
    assert out.count("served 6 requests") == 1
    assert _streams(out) == _streams(served_alone)


# --- (f) train_lm -----------------------------------------------------------

@pytest.mark.parametrize("argv", (
    [], ["--steps", "7", "--batch", "2", "--seq", "64"]),
    ids=("default", "given"))
@pytest.mark.parametrize("device", ("cuda", "cpu"))
def test_train_lm_hands_the_launcher_the_reference_argv(argv, device,
                                                        monkeypatch):
    J, T = reference("train_lm"), port("train_lm")
    got = {}
    monkeypatch.setattr(J, "train_main", lambda a: got.setdefault("jax", a))
    monkeypatch.setattr(T, "train_main",
                        lambda a: got.setdefault("torch", a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ckpt = os.path.join(tempfile.gettempdir(), "train_lm_ckpt")
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv,
                                      "--ckpt-dir", ckpt])
    J.main()
    assert T.main([*argv, "--ckpt-dir", ckpt, "--device", device]) == 0
    assert got["torch"] == got["jax"] + ["--device", device]
    # the one default that differs: the checkpoint directory lies under
    # the process's temporary directory, not a fixed /tmp path
    got.clear()
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv])
    J.main()
    T.main([*argv, "--device", device])
    at = got["torch"].index("--ckpt-dir") + 1
    assert got["torch"][at].startswith(tempfile.gettempdir())
    assert got["torch"][:at] + got["torch"][at + 1:] == \
        got["jax"][:at] + got["jax"][at + 1:] + ["--device", device]
