"""Single-step analysis CLI over the prediction-engine frontend.

The counterpart of ``repro/core/analyze.py``, which reads a compiled HLO
file. The port has no HLO: it lowers a config's decode step on meta
tensors (``serve/planner.decode_step_trace``: one chunk at serve shapes,
no memory, no device) and prices it on any registered machines with any
scheduling backends, in the reference's table:

    python -m repro_torch.core.analyze --config yi-9b --machine h100
    python -m repro_torch.core.analyze --config yi-9b --machine all \\
        --backend tp,mca

``--machine`` takes registered names (comma-separated and/or repeated)
or ``all``; ``--backend`` takes backend names or aliases (``tp``,
``mca``, ``osaca``, ``llvm-mca``, or the canonical ``tp_bound`` /
``mca_sched``). ``--smoke`` takes the config's smoke size. The table
reuses exactly the ``portmodel.compare`` fan-out the serve planner
consumes.
"""

from __future__ import annotations

import argparse

from repro_torch.core import portmodel
from repro_torch.core.backends import get_backend, registered_backends
from repro_torch.core.machine import get_machine, registered_names


def _split_multi(values, default: tuple, every: tuple) -> tuple:
    """Flatten repeated/comma-separated option values.

    No value -> ``default``; an explicit ``all`` -> ``every`` (the full
    registry, which for backends is wider than the default).
    """
    if not values:
        return default
    out: list = []
    for v in values:
        out.extend(x.strip() for x in v.split(",") if x.strip())
    if "all" in out:
        return every
    return tuple(dict.fromkeys(out))


def format_table(reports: dict, backends: tuple) -> str:
    """Render a nested ``{machine: {backend: Report}}`` as a table."""
    hdr = (f"{'machine':<13} {'backend':<10} {'bound cy':>12} "
           f"{'in-core cy':>12} {'sim cy':>12} {'t_bound':>10} "
           f"{'t_tier':>10} {'bottleneck':>12} {'tier':>5} "
           f"{'fallback':>8}")
    lines = [hdr, "-" * len(hdr)]
    for name, per in reports.items():
        m = get_machine(name)
        for bname in backends:
            rep = per[bname]
            sim = (f"{rep.sim_cycles:>12.3e}"
                   if rep.sim_cycles is not None else f"{'-':>12}")
            lines.append(
                f"{name:<13} {bname:<10} {rep.bound_cycles:>12.3e} "
                f"{rep.bound_incore_cycles:>12.3e} {sim} "
                f"{rep.seconds(m)*1e6:>8.1f}us "
                f"{rep.tier_bound_seconds(m)*1e6:>8.1f}us "
                f"{rep.bottleneck():>12} "
                f"{rep.bottleneck_tier or 'n/a':>5} "
                f"{rep.fallback_uops:>8}")
    return "\n".join(lines)


def step_trace(config: str, *, smoke: bool = False, batch: int = 8,
               max_len: int = 2048):
    """The decode step's ATen trace of a config (its smoke size with
    ``smoke``) at ``batch`` slots and a ``max_len`` horizon."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serve import planner
    cfg = (get_smoke_config if smoke else get_config)(config)
    return planner.decode_step_trace(cfg, batch, max_len)


def main(argv=None) -> int:
    """CLI entry point; returns a process exit status."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analyze",
        description="Analyze one config's decode step across machines "
                    "and scheduling backends.")
    ap.add_argument("--config", required=True,
                    help="config name (repro_torch.configs), e.g. yi-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke size")
    ap.add_argument("--batch", type=int, default=8, help="decode slots")
    ap.add_argument("--max-len", type=int, default=2048,
                    help="cache horizon (rows a slot)")
    ap.add_argument("--machine", action="append", default=None,
                    metavar="NAME[,NAME...]",
                    help="registered machine name(s); repeatable; "
                         "'all' (default) = every registered machine")
    ap.add_argument("--backend", action="append", default=None,
                    metavar="NAME[,NAME...]",
                    help="scheduling backend(s): tp|mca or canonical "
                         "names; repeatable (default: tp)")
    args = ap.parse_args(argv)

    machines = _split_multi(args.machine, registered_names(),
                            registered_names())
    backends = _split_multi(args.backend, ("tp_bound",),
                            registered_backends())
    # canonicalize aliases, then dedupe (tp + osaca are one backend)
    backends = tuple(dict.fromkeys(get_backend(b).name
                                   for b in backends))
    for m in machines:
        get_machine(m)          # fail fast with the registry's message
    tr = step_trace(args.config, smoke=args.smoke, batch=args.batch,
                    max_len=args.max_len)
    reports = portmodel.compare(tr, machines=machines, backends=backends)
    first = reports[next(iter(reports))][backends[0]]
    size = " (smoke)" if args.smoke else ""
    print(f"decode step: {args.config}{size}, {args.batch} slots, "
          f"{args.max_len}-row horizon  (ops={tr.n_ops()}, "
          f"instrs={first.n_instrs}, unknown={first.unknown_ops}, "
          f"backends={'/'.join(backends)}, "
          f"registered backends={'/'.join(registered_backends())})")
    print(format_table(reports, backends))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
