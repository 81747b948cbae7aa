"""How far xlstm-125m's sLSTM prefill moves under rounding-level changes:
one sLSTM layer at the published width, fp32, random weights (seed 1),
inputs of 16, 32, 64 and 128 tokens (seed 2), unsharded. Printed, as
max |diff| over the output's largest element, on the card and then on
the host: the same call again; one input element moved by one ulp; the
input projection of the heads' two halves taken apart (the arithmetic
of two TP ranks, each with its heads' columns).

    python scripts/slstm_rounding_probe.py
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def probe(torch, dev: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import xlstm as X
    cfg = dataclasses.replace(get_config("xlstm-125m"), param_dtype="float32",
                              n_layers=2)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    p = M._unstack(params["scan"], 1)[0]["1"]["mixer"]     # the sLSTM layer
    g = torch.Generator(device=dev).manual_seed(2)
    d, h = cfg.d_model, cfg.n_heads

    def halves(x_c, w, b, r, c, n, hp, m, *, dh, valid=None):
        wx = torch.cat([(torch.einsum("btd,dge->btge", x_c, w[..., k])
                         + b[..., k]).float()
                        for k in (slice(0, d // 2), slice(d // 2, d))], -1)
        return X.slstm_steps(wx, r, c, n, hp, m, dh=dh, valid=valid)

    for t in (16, 32, 64, 128):
        x = torch.randn((2, t, d), generator=g, device=dev)
        y0, _ = X.slstm_mixer(p, x, n_heads=h)
        again, _ = X.slstm_mixer(p, x.clone(), n_heads=h)
        xp = x.clone()
        xp[0, 0, 0] = torch.nextafter(xp[0, 0, 0],
                                      torch.tensor(1e9, device=dev))
        ulp, _ = X.slstm_mixer(p, xp, n_heads=h)
        split, _ = X.slstm_mixer(p, x, n_heads=h, on_shards=lambda core, a:
                                 halves(*a, **core.keywords))
        scale = float(y0.abs().max())

        def rel(y):
            return float((y - y0).abs().max()) / scale
        print(f"{dev} T={t}: repeat {rel(again):.3e}; 1-ulp input change "
              f"{rel(ulp):.3e}; heads projected in halves {rel(split):.3e} "
              f"(of max |y| {scale:.3e})", flush=True)


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        print("slstm_rounding_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    for dev in ("cuda", "cpu"):
        probe(torch, dev)
