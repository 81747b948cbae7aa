"""Fig. 6 (extension): serve-engine tokens/s, predicted against measured,
with WA-priced KV-cache update traffic per machine, on the port.

The counterpart of ``benchmarks/fig6_serve.py``. The continuous-batching
engine (``repro_torch.serve``) serves gemma3-4b: at its published width
and depth on the card, its smoke configuration on the CPU. The same
decode step's ATen trace (``serve.planner.decode_step_trace``, the
port's counterpart of ``decode_step_hlo``) is priced on every registered
machine by ``plan_chunk_size``, and each machine's tier-resolved step
becomes a predicted tokens/s. Beside it, the per-step KV-update traffic
is priced through ``wa`` in both regimes, donated (in place) and copied,
so the donation delta is reported per machine in bytes a step.

Measured tokens/s mixes the prefill and the decode, so the measured row
also gives the prefill seconds and the decode milliseconds a step apart
(``ServeEngine.stats``). The CPU run is a functional anchor; the card's
is the port's measurement.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.bench._common import model, on_card, where
from repro_torch.core.machine import registered_names
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.kv_traffic import kv_update_traffic
from repro_torch.serve.planner import decode_step_trace, plan_chunk_size

ARCH = "gemma3-4b"           # local+global attention: both cache kinds
#: (batch, prompt tokens): the reference's on the CPU, the card's
#: serving batch with a longer prompt on the card
BATCH, PROMPT = 4, 16
CARD_BATCH, CARD_PROMPT = 8, 128


def serve_record(gen: int = 32, device="cuda") -> dict:
    """Run the engine once (warm), then again timed; assemble the record."""
    batch, prompt = (CARD_BATCH, CARD_PROMPT) if on_card(device) \
        else (BATCH, PROMPT)
    cfg, params = model(ARCH, device)
    max_len = prompt + gen
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt))
    plan = plan_chunk_size(cfg, batch, max_len, max_chunk=min(16, gen - 1))
    n_ops = decode_step_trace(cfg, batch, max_len).n_ops()
    eng = ServeEngine(cfg, params, max_slots=batch, max_len=max_len,
                      chunk=plan.chunk, device=device)
    reqs = [Request(rid=str(i), prompt=tuple(int(t) for t in prompts[i]),
                    max_new_tokens=gen) for i in range(batch)]
    eng.run(list(reqs))          # warm-up: graphs captured, kernels built
    eng.decode_dispatches = eng.prefill_dispatches = eng.decode_tokens = 0
    eng.prefill_s = eng.decode_s = 0.0
    t0 = time.perf_counter()
    out = eng.run(list(reqs))    # slots all retired: re-admit
    dt = time.perf_counter() - t0
    if not all(len(v) == gen for v in out.values()):
        raise AssertionError("a request got short of its budget")
    st = eng.stats()
    # predicted: per-machine tier-resolved seconds of one 1-token decode
    # step; a chunk of n costs n steps
    pred = {name: batch / max(t, 1e-12)
            for name, t in plan.per_machine.items()}
    return {"arch": ARCH, "batch": batch, "gen": gen, "prompt": prompt,
            "chunk": plan.chunk, "plan_machine": plan.machine,
            "trace_ops": n_ops,
            "dispatches": eng.decode_dispatches,
            "measured_tok_s": batch * gen / dt, "wall_s": dt,
            "prefill_s": st["prefill_s"],
            "decode_ms_step": st["decode_s"] / max(1, st["decode_tokens"])
            * 1e3,
            "pred_tok_s": pred,
            "kv_rows": kv_update_traffic(cfg, batch, max_len)}


def main(quick: bool = False, device="cuda"):
    """Emit the fig6 serve table as benchmark CSV lines."""
    rec = serve_record(gen=16 if quick else 32, device=device)
    lines = [
        f"fig6,measured.{'card' if on_card(device) else 'host'},"
        f"{rec['wall_s']*1e6:.0f},"
        f"tok_s={rec['measured_tok_s']:.1f};"
        f"prefill_s={rec['prefill_s']:.4f};"
        f"decode_ms_step={rec['decode_ms_step']:.3f};arch={rec['arch']};"
        f"batch={rec['batch']};prompt={rec['prompt']};gen={rec['gen']};"
        f"chunk={rec['chunk']};dispatches={rec['dispatches']};"
        f"plan={rec['plan_machine']};trace_ops={rec['trace_ops']};"
        f"device={where(device)}"
    ]
    kv_by_machine = {r["machine"]: r for r in rec["kv_rows"]}
    for name in registered_names():
        if name not in rec["pred_tok_s"]:
            continue
        t_step = 1.0 / rec["pred_tok_s"][name] * rec["batch"]
        kv = kv_by_machine.get(name)
        kv_part = (f"kv_donated={kv['donated_bytes']/1e3:.1f}kB;"
                   f"kv_copied={kv['copied_bytes']/1e6:.2f}MB;"
                   f"kv_delta={kv['delta_bytes']/1e6:.2f}MB;"
                   f"wa_mode={kv['wa_mode']}" if kv else "kv=n/a")
        lines.append(
            f"fig6,pred.{name},{t_step*1e6:.1f},"
            f"tok_s={rec['pred_tok_s'][name]:.0f};{kv_part}")
    # the WA story must hold on the serve path: donation strictly cheaper
    # than copying on every machine
    bad = [r["machine"] for r in rec["kv_rows"]
           if not r["delta_bytes"] > 0]
    lines.append(f"fig6,donation_delta,0,"
                 f"positive_on_all={'OK' if not bad else bad}")
    if bad:
        raise AssertionError(f"donation delta non-positive on: {bad}")
    return lines


if __name__ == "__main__":
    print("\n".join(main()))
