"""Roofline terms from dry-run records, on the H100.

The port of ``src/repro/launch/roofline.py``. Terms per (arch x shape)
cell, per device and in seconds:

  compute    = sum over dtypes of FLOPs(dtype) / peak(dtype)
  memory     = bytes accessed / HBM rate (the eager operators' traffic)
  collective = 0 (the port runs no collective)

The peaks are the H100 SXM's published dense rates (NVIDIA's H100 data
sheet, SXM part, without sparsity, at its 700 W limit): 989 TFLOP/s in
bf16 and fp16 on the tensor cores, 1,979 TOP/s in int8 there, 67 TFLOP/s
in float32 (and 32-bit integer operations) outside them, 3.35 TB/s of
HBM; ``chip_smoke.py`` takes its kernel bounds from here too. The
compute term is a sum over dtypes, not one peak: the port's attention
scores, P.V and tied head run as f32 products on the CUDA cores, whose
peak is a fifteenth of the bf16 tensor cores'.

The port's dry run (``repro_torch.launch.dryrun``) counts the whole
step's FLOPs and bytes (``"flops_scope": "global"``); this module splits
them evenly over the mesh's devices and reads no other record (a record
of the reference's dry run, counted per device by XLA on the TPU's
partitioning, is refused). The port runs no collective (it has no SPMD
partitioner), so its records carry no wire bytes and the collective term
is 0: no link rate is reckoned for the card.

``bytes accessed`` counts every non-view operator's inputs and outputs,
XLA's definition: the eager operators' traffic, an upper bound on what
the device must move (about what an eager step streams, but for L2
hits). The memory term is that traffic over the HBM rate, not a
roofline: a step that adds passes raises it.

MODEL_FLOPS uses the classic accounting: train 6·N_active·tokens,
prefill 2·N_active·tokens, decode 2·N_active·batch per step. ``useful``
is MODEL_FLOPS over the step's counted FLOPs; ``mfu_like`` = compute /
max(all terms).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16/fp16, tensor cores
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SCALAR_OPS_PER_S = 67e12        # H100 SXM non-tensor 32-bit operations
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8, tensor cores
HBM_BW = 3.35e12                # H100 SXM HBM3, bytes/s

# FLOP/s by the dtype name of a product's operands.
PEAK_FLOPS = {"bfloat16": BF16_FLOPS_PER_S, "float16": BF16_FLOPS_PER_S,
              "float32": F32_FLOPS_PER_S}
RESULTS_DIR = Path(__file__).resolve().parents[3] / "chiprun_out" / "analysis"

_WIRE = {"all-reduce": ("in", 2.0), "all-gather": ("out", 1.0),
         "reduce-scatter": ("in", 1.0), "all-to-all": ("in", 1.0),
         "collective-permute": ("out", 1.0)}


def wire_bytes(coll: dict) -> float:
    total = 0.0
    for kind, (field, mult) in _WIRE.items():
        total += mult * coll.get(kind, {}).get(field, 0)
    return total


def compute_seconds(flops_by_dtype: dict) -> float:
    """Sum over dtypes of FLOPs at that dtype's peak; raises ``KeyError``
    for a dtype the table has no rate for."""
    return sum(f / PEAK_FLOPS[dt] for dt, f in flops_by_dtype.items())


def model_flops(arch: str, shape: str) -> float:
    from repro_torch.configs import SHAPES, get_model

    api = get_model(arch)
    spec = SHAPES[shape]
    n_active = api.active_param_count()
    if spec.kind == "train":
        return 6.0 * n_active * spec.seq_len * spec.global_batch
    if spec.kind == "prefill":
        return 2.0 * n_active * spec.seq_len * spec.global_batch
    return 2.0 * n_active * spec.global_batch  # decode: one token / sequence


def _advice(dom: str, row: dict) -> str:
    if dom == "collective":
        k = max(row["coll_detail"], key=lambda kk: row["coll_detail"][kk])
        return (f"dominated by {k}: reshard to turn it into overlapped "
                f"reduce-scatter/all-gather or shrink the payload dtype")
    if dom == "memory":
        if row["useful"] < 0.4:
            return ("HBM-bound with low useful-FLOP ratio: cut remat "
                    "recompute / fuse dispatch einsums")
        return "HBM-bound: fuse elementwise chains, widen arithmetic intensity"
    if row["useful"] < 0.5:
        return "compute-bound but half the FLOPs are overhead: fix remat/dispatch"
    return "near compute roofline: only kernel-level wins left"


def build_table(mesh: str = "single",
                results_dir: Optional[Path] = None) -> list[dict]:
    """One row per (arch x shape) cell from ``dryrun_<mesh>.json`` under
    ``results_dir`` (default ``RESULTS_DIR``)."""
    from repro_torch.configs import ALIASES, SHAPES, cell_valid

    path = Path(results_dir or RESULTS_DIR) / f"dryrun_{mesh}.json"
    data = json.loads(path.read_text()) if path.exists() else {}
    rows = []
    for arch in ALIASES:
        for shape in SHAPES:
            key = f"{arch}|{shape}"
            ok, reason = cell_valid(arch, shape)
            if not ok:
                rows.append({"arch": arch, "shape": shape, "skip": reason})
                continue
            rec = data.get(key)
            if not rec or "cost" not in rec or "flops" not in rec.get("cost", {}):
                rows.append({"arch": arch, "shape": shape,
                             "skip": "no dry-run record"})
                continue
            rows.append(_row(arch, shape, rec))
    return rows


def _row(arch: str, shape: str, rec: dict) -> dict:
    """A port record's terms per chip: its global count split evenly."""
    if rec.get("flops_scope") != "global" or wire_bytes(rec["collectives"]):
        raise ValueError(f"{arch}|{shape}: not a record of the port's dry "
                         f"run (a global count with no collectives)")
    chips = 1
    for v in rec["mesh"].values():
        chips *= v
    cost = rec["cost"]
    flops = cost["flops"] / chips
    hbytes = cost["bytes accessed"] / chips
    by_dtype = {dt: f / chips for dt, f in cost["flops_by_dtype"].items()}
    compute_s = compute_seconds(by_dtype)
    memory_s = hbytes / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    dom = max(terms, key=terms.get)
    mf = model_flops(arch, shape)
    useful = mf / (chips * flops) if flops else 0.0
    row = {
        "arch": arch, "shape": shape, "kind": rec["kind"],
        "chips": chips,
        "unrolled": True,       # an eager count visits every layer
        "flops_per_chip": flops, "bytes_per_chip": hbytes,
        "wire_bytes_per_chip": 0.0,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": 0.0, "dominant": dom,
        "model_flops": mf, "useful": useful,
        "mfu_like": compute_s / max(max(terms.values()), 1e-30),
        "memory_bytes_per_device": rec.get("memory", {}),
        "flops_by_dtype_per_chip": by_dtype,
    }
    row["advice"] = _advice(dom, row)
    return row


def render(rows: list[dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s} "
           f"{'coll_s':>10s} {'dominant':>10s} {'useful':>7s} {'frac':>6s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("skip"):
            lines.append(f"{r['arch']:22s} {r['shape']:12s} SKIP: {r['skip']}")
            continue
        lines.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['compute_s']:10.4f} "
            f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
            f"{r['dominant']:>10s} {r['useful']:7.3f} {r['mfu_like']:6.3f}")
    if any("flops_by_dtype_per_chip" in r for r in rows):
        peaks = ", ".join(f"{dt} {f:g}" for dt, f in PEAK_FLOPS.items())
        lines.append(f"FLOPs and bytes: the whole step's count split evenly "
                     f"over the mesh's chips; peaks FLOP/s {peaks}; "
                     f"memory_s: the eager operators' traffic at HBM "
                     f"{HBM_BW:g} B/s (an upper bound, not a roofline)")
        lines.append("coll_s: no collectives (no partitioner)")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args(argv)
    print(render(build_table(args.mesh, args.results_dir)))


if __name__ == "__main__":
    main()
