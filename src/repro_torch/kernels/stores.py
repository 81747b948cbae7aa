"""KV row writer: the CUDA kernel's wrapper, its plain PyTorch version,
the prefill horizon fill, and store-flavor resolution.

The counterpart of ``repro/kernels/stores.py``. The kernel
(``csrc/stores.cu``) replaces the Pallas TPU kernel
``stores.py:_kv_write_nt`` (body ``_kv_row_kernel``): one launch writes
the K and the V rows of one layer in place, one thread block per
(slot, token), and touches no other row. On the H100 it is bound by
launch latency: at yi-9b's shapes a launch moves 16 KiB each way. So
the decode step does not launch it: the decode kernels write the step's
rows in the launch that reads the cache right after
(``attention.decode.flash_decode`` with ``k_new``/``v_new``, the same
rows and flavors). This module keeps the standalone writer and the plain
versions of both writes.

Store flavors:

* ``"standard"`` — plain stores.
* ``"nt"`` — streaming (evict-first) stores, ``st.global.cs``. The
  bytes written are identical to ``"standard"``.
* ``"auto"`` — the cheaper flavor the machine file's memory ladder
  models (:func:`resolve_flavor`, :func:`plan_stores`; the JAX
  package's selector, copied). On ``h100`` that is ``"standard"``: the
  card claims lines on store (``auto_claim``, residue 0), so streaming
  stores buy nothing, as its INIT streams show. The kernels run
  :func:`executed_flavor`'s flavor, which takes ``"auto"`` as
  ``"standard"`` without pricing it at every launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import LAUNCHES, build, pos_vector, use_kernel

#: the public flavor vocabulary
STORE_FLAVORS = ("standard", "nt", "auto")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "kv_row_update": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _L, _L, _L, _L, _I, _P],
}


#: selection tolerance: "nt" must beat "standard" by more than this
#: ratio margin (ties and noise go to the standard path)
_SELECT_EPS = 1e-9


def _check(flavor: str | None) -> None:
    if flavor is not None and flavor not in STORE_FLAVORS:
        raise ValueError(f"unknown store flavor {flavor!r} "
                         f"(expected one of {STORE_FLAVORS})")


@dataclasses.dataclass(frozen=True)
class StorePlan:
    """One store-path decision and the modeled ratios behind it."""

    machine: str              # registered machine name
    flavor: str               # chosen flavor: "standard" | "nt"
    wa_mode: str              # the machine's Fig. 4 behavioural mode
    ratio_standard: float     # modeled traffic ratio, standard stores
    ratio_nt: float           # modeled traffic ratio, NT stores
    saturation: float         # modeled interface saturation used, 0..1
    ws_bytes: float | None    # working set the ratios were gated on

    @property
    def ratio(self) -> float:
        """Modeled traffic ratio of the *chosen* flavor."""
        return self.ratio_nt if self.flavor == "nt" \
            else self.ratio_standard


def flavor_ratios(machine, *, ws_bytes: float | None = None,
                  cores_active: int | None = None,
                  bw_utilization: float | None = None,
                  tile_full_frac: float = 1.0) -> tuple:
    """(standard, nt) modeled traffic ratios on one machine, both from
    the ladder-residue path (``core.wa.ladder_traffic_ratio``)."""
    from repro_torch.core import wa
    kw = dict(ws_bytes=ws_bytes, cores_active=cores_active,
              bw_utilization=bw_utilization,
              tile_full_frac=tile_full_frac)
    return (wa.ladder_traffic_ratio(machine, nt_stores=False, **kw),
            wa.ladder_traffic_ratio(machine, nt_stores=True, **kw))


def plan_stores(machine=None, *, flavor: str = "auto",
                ws_bytes: float | None = None,
                cores_active: int | None = None,
                bw_utilization: float | None = None) -> StorePlan:
    """Resolve the store path for one machine into a :class:`StorePlan`.

    ``flavor="auto"`` picks the cheaper modeled flavor (ties ->
    ``standard``); an explicit ``"standard"``/``"nt"`` is honoured but
    the plan still records both ratios. ``ws_bytes`` gates the SpecI2M
    saturation model on the real working set (omitted -> the stream is
    assumed DRAM-bound at full saturation); ``machine`` defaults to the
    tuner's target (``kernels.tuning.default_machine``).
    """
    from repro_torch.core import wa
    from repro_torch.core.machine import get_machine
    from repro_torch.core.memtier import modeled_saturation
    if machine is None:
        from repro_torch.kernels.tuning import default_machine
        machine = default_machine()
    m = get_machine(machine) if isinstance(machine, str) else machine
    if flavor not in STORE_FLAVORS:
        raise ValueError(f"unknown store flavor {flavor!r} "
                         f"(expected one of {STORE_FLAVORS})")
    r_std, r_nt = flavor_ratios(m, ws_bytes=ws_bytes,
                                cores_active=cores_active,
                                bw_utilization=bw_utilization)
    if flavor == "auto":
        flavor = "nt" if r_nt < r_std - _SELECT_EPS else "standard"
    sat = bw_utilization
    if sat is None:
        sat = (modeled_saturation(m, ws_bytes, cores_active)
               if ws_bytes is not None else 1.0)
    return StorePlan(machine=m.name, flavor=flavor,
                     wa_mode=wa.wa_mode_of(m),
                     ratio_standard=r_std, ratio_nt=r_nt,
                     saturation=sat, ws_bytes=ws_bytes)


def select_store_flavor(machine=None, *, ws_bytes: float | None = None,
                        cores_active: int | None = None,
                        bw_utilization: float | None = None) -> str:
    """The cheaper modeled store flavor for one machine: ``"nt"`` on Zen
    4 (``explicit_only``), ``"standard"`` on Grace, the TPUs and the
    H100 (``auto_claim``), on SPR ``"nt"`` only while the modeled
    SpecI2M gate is closed."""
    return plan_stores(machine, flavor="auto", ws_bytes=ws_bytes,
                       cores_active=cores_active,
                       bw_utilization=bw_utilization).flavor


def resolve_flavor(flavor: str | None, machine=None, *,
                   ws_bytes: float | None = None,
                   cores_active: int | None = None) -> str:
    """Validate a flavor string and resolve ``"auto"`` per machine
    (``None`` reads as ``"auto"``): the JAX package's selection."""
    _check(flavor)
    if flavor not in (None, "auto"):
        return flavor
    return select_store_flavor(machine, ws_bytes=ws_bytes,
                               cores_active=cores_active)


def executed_flavor(flavor: str | None) -> str:
    """The flavor the kernels execute: an explicit ``"standard"`` or
    ``"nt"`` as given, ``"auto"`` and ``None`` as ``"standard"``.

    The JAX package executes a machine-selected ``"auto"`` only on a TPU
    and ``"standard"`` elsewhere. The port keeps its rule: the card's
    machine file selects ``"standard"`` (:func:`resolve_flavor`), which
    is what ``"auto"`` runs, and a launch prices nothing.
    """
    _check(flavor)
    return "standard" if flavor in (None, "auto") else flavor


def ref_kv_row_update(k_cache, v_cache, k_new, v_new, pos) -> None:
    """Plain PyTorch version of the kernel, in place.

    Row ``(b, j)`` of each update lands at ``cache[b, p_b + j]`` with
    ``p_b = clamp(pos[b], 0, S - Sq)``, the clamp of JAX's
    ``dynamic_update_slice`` (which, like JAX, first counts a negative
    ``pos[b]`` from the end).
    """
    b, s = k_cache.shape[:2]
    sq = k_new.shape[1]
    dev = k_cache.device
    start = pos.to(dev).long()
    start = torch.where(start < 0, start + s, start).clamp(0, s - sq)
    rows = start[:, None] + torch.arange(sq, device=dev)[None, :]
    slots = torch.arange(b, device=dev)[:, None]
    k_cache[slots, rows] = k_new.to(k_cache.dtype)
    v_cache[slots, rows] = v_new.to(v_cache.dtype)


def writes_rows(k_new, v_new, flavor: str | None) -> bool:
    """Whether a decode call is given new rows to write: validates the
    flavor, and that ``k_new`` and ``v_new`` come together."""
    _check(flavor)
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new come together")
    return k_new is not None


def ref_paged_row_update(k_pages, v_pages, block_tables, k_new, v_new,
                         pos) -> None:
    """Plain version of the paged decode kernel's row write, in place:
    the reference model's scatter (``repro/models/model.py``, paged
    decode). Row 0 of slot ``b``'s new rows (B, Sq, Hkv, Dh) lands at row
    ``pos[b] % page`` of page ``block_tables[b, min(pos[b] // page, NB -
    1)]`` of the (P, page, Hkv, Dh) pools, ``NB`` the table's columns (the
    clamp retires an overshooting slot onto its last column). A negative
    ``pos[b]`` wraps to the table's last columns, as the reference's
    indexing does, and so does the paged decode kernel's fused write."""
    b = k_new.shape[0]
    ps, nb = k_pages.shape[1], block_tables.shape[1]
    dev = k_pages.device
    p1 = pos_vector(pos, b, dev).long()
    lp = torch.clamp(p1 // ps, max=nb - 1)
    phys = block_tables.to(dev)[torch.arange(b, device=dev), lp].long()
    row = p1 % ps
    k_pages[phys, row] = k_new[:, 0].to(k_pages.dtype)
    v_pages[phys, row] = v_new[:, 0].to(v_pages.dtype)


def _check_kernel_inputs(k_cache, v_cache, k_new, v_new, pos) -> None:
    """Raise on anything the CUDA kernel does not take."""
    b, s, hkv, dh = k_cache.shape
    sq = k_new.shape[1]
    for name, x in (("v_cache", v_cache), ("k_new", k_new),
                    ("v_new", v_new), ("pos", pos)):
        if x.device != k_cache.device:
            raise ValueError(f"{name} is on {x.device}, k_cache on "
                             f"{k_cache.device}")
    if v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError("k_cache and v_cache differ in shape or dtype")
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if x.shape != (b, sq, hkv, dh) or x.dtype != k_cache.dtype \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous "
                             f"{(b, sq, hkv, dh)} {k_cache.dtype} tensor")
    if sq > s:
        raise ValueError(f"{sq} update rows do not fit a {s}-row cache")
    isz = k_cache.element_size()
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.stride(3) != 1 or c.stride(2) != dh \
                or (c.stride(0) * isz) % 16 or (c.stride(1) * isz) % 16 \
                or c.data_ptr() % 16:
            raise ValueError(f"{name} rows must be contiguous and "
                             "16-byte aligned")
    if (hkv * dh * isz) % 16 or k_new.data_ptr() % 16 \
            or v_new.data_ptr() % 16:
        raise ValueError("KV rows must be a multiple of 16 bytes, aligned")
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError("pos must be a contiguous int32 (B,) tensor")


def kv_row_update(k_cache, v_cache, k_new, v_new, pos, *,
                  flavor: str | None = "standard",
                  impl: str = "auto") -> None:
    """Write one layer's K and V update rows into its caches, in place.

    ``k_cache``/``v_cache`` are (B, S, Hkv, Dh); ``k_new``/``v_new``
    (B, Sq, Hkv, Dh); ``pos`` a scalar or (B,) int32. Row ``b`` lands at
    ``cache[b, pos[b]:pos[b]+Sq]``, its start clamped into ``[0, S-Sq]``
    as JAX's ``dynamic_update_slice`` clamps it (a negative start counts
    from the end first, as in JAX). The caches keep their
    storage (same ``data_ptr()``). ``flavor`` picks the store path (see
    the module docstring), ``impl`` the kernel or its plain version. The
    decode step writes the same rows through the decode call instead.
    """
    run = executed_flavor(flavor)
    pos = pos_vector(pos, k_cache.shape[0], k_cache.device)
    if not use_kernel(impl, k_cache):
        ref_kv_row_update(k_cache, v_cache, k_new, v_new, pos)
        return
    k_new = k_new.to(k_cache.dtype).contiguous()
    v_new = v_new.to(v_cache.dtype).contiguous()
    _check_kernel_inputs(k_cache, v_cache, k_new, v_new, pos)
    lib = build.load("stores", _SIGNATURES)
    b, s, hkv, dh = k_cache.shape
    isz = k_cache.element_size()
    rc = lib.kv_row_update(
        k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), b, k_new.shape[1], s,
        hkv * dh * isz, k_cache.stride(0) * isz, k_cache.stride(1) * isz,
        v_cache.stride(0) * isz, v_cache.stride(1) * isz,
        int(run == "nt"),
        torch.cuda.current_stream(k_cache.device).cuda_stream)
    build.check(lib, rc, "kv_row_update")
    LAUNCHES["kv_row_update"] += 1


def pad_to_horizon(x, cache_len: int, *, flavor: str | None = "standard"):
    """Grow a prefill KV leaf (B, S, Hkv, Dh) to the decode horizon.

    Zero rows are appended up to ``cache_len``; a leaf already at the
    horizon comes back as is. Both flavors produce the same bytes (the
    JAX ``"nt"`` lowering differs only in how XLA writes them).
    """
    _check(flavor)
    s = x.shape[1]
    if cache_len <= s:
        return x
    return F.pad(x, (0, 0, 0, 0, 0, cache_len - s))
