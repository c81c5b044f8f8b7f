"""Fleet reliability simulation command line of the port.

Runs the event-driven simulator (``repro_torch.sim``) for one
scheme/config and prints a JSON summary; ``--closed-form`` adds the
Markov-chain MTTDL for side-by-side comparison, ``--oracle`` re-runs the
pure-Python reference loop and verifies the batched engine against it bit
for bit (exit 1 on divergence), and ``--calibrate DIR`` first measures the
real repair pipeline's effective bandwidth on a scratch store under DIR
and feeds it into the failure model, and ``--replay TRACE.json`` drives a
real store through a failure trace instead of simulating. The engine's
selects and draws, the oracle's draws and the calibration and replay
stores' kernels run on ``--device``: the card by default, ``--device cpu``
for the host.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.simulate --scheme cp-azure \\
      --k 6 --r 2 --p 2 --trials 500 --horizon-hours 8000 \\
      --disk-mttf-hours 200 --bandwidth-gbps 0.002 --closed-form
  PYTHONPATH=src python -m repro_torch.launch.simulate --scheme azure \\
      --k 4 --r 2 --p 1 --trials 50 --horizon-hours 2000 --oracle \\
      --events out.json --device cpu
  PYTHONPATH=src python -m repro_torch.launch.simulate \\
      --replay tests/data/correlated_trace.json --nodes 24 --domains 12 \\
      --policy spread --schedule global --destinations topology \\
      --rebalance --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from repro_torch.core.reliability import (HOURS_PER_YEAR,
                                          ReliabilityParams,
                                          stripe_mttdl_years)
from repro_torch.core.schemes import make_scheme
from repro_torch.device import resolve_device
from repro_torch.dist.topology import POLICIES, Topology
from repro_torch.ftx.events import to_doc
from repro_torch.sim import (SimParams, UnitHierarchy, calibrated, simulate,
                             simulate_oracle)
from repro_torch.sim.units import COST_MODELS, MODELS


def _replay(args, device) -> int:
    """``--replay``: drive a real store through a committed failure trace.

    Builds a scratch :class:`~repro_torch.ftx.StripeStore` on ``device``
    under the requested geometry, fills it with seeded deterministic
    objects, and replays the trace through
    :func:`repro_torch.ftx.failures.replay_trace` — correlated
    same-timestamp failures repair as one batch, under the requested
    orchestration knobs. The printed JSON carries only deterministic
    fields (simulated time, block/read counts, relocations, rebalance
    moves), so two runs over the same trace are byte-identical, and equal
    to the reference command's.
    """
    import tempfile

    import numpy as np

    from repro_torch.ftx.events import load_trace
    from repro_torch.ftx.failures import replay_trace
    from repro_torch.ftx.options import RepairOptions
    from repro_torch.ftx.stripestore import StoreConfig, StripeStore

    nodes = args.nodes or 24
    topo = Topology(num_nodes=nodes, num_domains=args.domains, seed=args.seed)
    cfg = StoreConfig(scheme=args.scheme, k=args.k, r=args.r, p=args.p,
                      block_size=1024, batch_stripes=8,
                      placement_policy=args.policy, seed=args.seed)
    with tempfile.TemporaryDirectory() as scratch:
        root = args.replay_store or scratch
        store = StripeStore(Path(root) / "replay_store", cfg,
                            num_nodes=nodes, topology=topo, device=device)
        rng = np.random.default_rng(args.seed)
        for i in range(12):
            store.put(f"obj{i}", rng.integers(
                0, 256, 4 * args.k * cfg.block_size // 5,
                dtype=np.uint8).tobytes())
        store.seal()
        events = load_trace(args.replay)
        res = replay_trace(store, events,
                           options=RepairOptions(
                               schedule=args.schedule,
                               destinations=args.destinations),
                           revive=args.destinations != "topology",
                           rebalance_after=args.rebalance)
    # Simulated seconds accumulate across reader-pool threads, so their
    # float sum can wiggle in the last ulp between runs; round them to a
    # stable precision. Every other replay field is an exact count.
    for row in res["batches"] + [res["totals"]]:
        row["sim_seconds"] = round(row["sim_seconds"], 6)
    out = {
        "scheme": args.scheme, "k": args.k, "r": args.r, "p": args.p,
        "nodes": nodes, "domains": args.domains, "policy": args.policy,
        "trace": args.replay, "trace_events": len(events),
        "schedule": args.schedule or cfg.stripe_schedule,
        "destinations": args.destinations or cfg.rebuild_destinations,
        "batches": res["batches"], "totals": res["totals"],
        "rebalance": res["rebalance"],
    }
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scheme", default="cp-azure")
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--trials", type=int, default=500)
    ap.add_argument("--horizon-hours", type=float, default=8000.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", choices=MODELS, default="paper")
    ap.add_argument("--cost-model", choices=COST_MODELS, default="planner")
    ap.add_argument("--disk-mttf-hours", type=float, default=None,
                    help="mean disk life (default: reliability params' "
                         "node MTTF)")
    ap.add_argument("--weibull-shape", type=float, default=1.0)
    ap.add_argument("--node-burst-hours", type=float, default=0.0)
    ap.add_argument("--rack-burst-hours", type=float, default=0.0)
    ap.add_argument("--lse-hours", type=float, default=0.0)
    ap.add_argument("--scrub-hours", type=float, default=0.0)
    ap.add_argument("--bandwidth-gbps", type=float, default=None)
    ap.add_argument("--nodes", type=int, default=None,
                    help="fleet nodes (default: one per disk)")
    ap.add_argument("--domains", type=int, default=1)
    ap.add_argument("--policy", choices=POLICIES, default="contiguous")
    ap.add_argument("--closed-form", action="store_true",
                    help="also evaluate the Markov-chain MTTDL")
    ap.add_argument("--oracle", action="store_true",
                    help="re-run the pure-Python oracle and verify the "
                         "batched engine bit for bit")
    ap.add_argument("--calibrate", metavar="DIR", default=None,
                    help="measure real repair-pipeline bandwidth on a "
                         "scratch store under DIR and use it")
    ap.add_argument("--events", metavar="OUT.json", default=None,
                    help="record per-trial FleetEvent logs to a file")
    ap.add_argument("--replay", metavar="TRACE.json", default=None,
                    help="replay a FleetEvent trace against a real "
                         "StripeStore with correlated-arrival batching "
                         "(repro_torch.ftx.failures.replay_trace) instead "
                         "of running the simulator")
    ap.add_argument("--replay-store", metavar="DIR", default=None,
                    help="scratch directory for the replay store "
                         "(default: a temp dir)")
    ap.add_argument("--schedule", default=None,
                    choices=("none", "locality", "global"),
                    help="stripe schedule for --replay repairs")
    ap.add_argument("--destinations", default=None,
                    choices=("in_place", "topology"),
                    help="rebuild destinations for --replay repairs")
    ap.add_argument("--rebalance", action="store_true",
                    help="run one rebalance pass after the --replay trace")
    ap.add_argument("--device", default="cuda",
                    help='where selects, draws, and calibration and '
                         'replay kernels run: "cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.replay:
        return _replay(args, device)

    scheme = make_scheme(args.scheme, args.k, args.r, args.p)
    rel = ReliabilityParams()
    if args.bandwidth_gbps is not None:
        rel = dataclasses.replace(rel, bandwidth_gbps=args.bandwidth_gbps)
    if args.calibrate:
        from repro_torch.ftx.stripestore import StoreConfig
        from repro_torch.sim import measure_repair_bandwidth

        tele = measure_repair_bandwidth(
            Path(args.calibrate),
            StoreConfig(scheme=args.scheme, k=args.k, r=args.r, p=args.p,
                        block_size=2048), device=device)
        rel = calibrated(rel, tele)
        print(f"# measured repair bandwidth: {tele['gbps']:.4f} Gbps",
              file=sys.stderr)
    params = SimParams(
        disk_mttf_hours=(args.disk_mttf_hours if args.disk_mttf_hours
                         else rel.node_mttf_years * HOURS_PER_YEAR),
        weibull_shape=args.weibull_shape,
        node_burst_hours=args.node_burst_hours,
        rack_burst_hours=args.rack_burst_hours,
        lse_hours=args.lse_hours, scrub_hours=args.scrub_hours,
        model=args.model, cost_model=args.cost_model, reliability=rel)
    topo = (Topology(num_nodes=args.nodes, num_domains=args.domains)
            if args.nodes else None)
    hier = UnitHierarchy.from_topology(scheme.n, topo, args.policy)
    kw = dict(trials=args.trials, horizon_hours=args.horizon_hours,
              seed=args.seed, hierarchy=hier,
              record_events=bool(args.events or args.oracle),
              device=device)
    res = simulate(scheme, params, **kw)
    out = {
        "scheme": args.scheme, "k": args.k, "r": args.r, "p": args.p,
        "model": args.model, "cost_model": args.cost_model,
        "trials": res.trials, "horizon_hours": res.horizon_hours,
        "seed": res.seed, "losses": res.losses,
        "observed_hours": res.observed_hours,
        "mttdl_hours": res.mttdl_hours, "mttdl_years": res.mttdl_years,
        "events": res.events, "epochs": res.epochs,
        "event_parallelism": res.event_parallelism,
        "events_per_sec": res.events / max(res.wall_seconds, 1e-9),
        "counts": res.counts, "wall_seconds": res.wall_seconds,
    }
    if args.closed_form:
        # Chain and sim must price failures at the same disk rate.
        chain_rel = dataclasses.replace(
            rel, node_mttf_years=params.disk_mttf_hours / HOURS_PER_YEAR)
        out["closed_form_years"] = stripe_mttdl_years(scheme, chain_rel,
                                                      model=args.model)
        if out["mttdl_years"] != float("inf"):
            out["sim_over_closed_form"] = (out["mttdl_years"]
                                           / out["closed_form_years"])
    if args.oracle:
        ref = simulate_oracle(scheme, params, **kw)
        mismatches = sum(a != b for a, b in zip(res.event_log,
                                                ref.event_log))
        out["oracle"] = {"losses": ref.losses,
                         "observed_hours": ref.observed_hours,
                         "trials_mismatching_engine": mismatches,
                         "bit_identical": mismatches == 0 and
                         res.observed_hours == ref.observed_hours}
        if not out["oracle"]["bit_identical"]:
            print("ERROR: batched engine diverged from the oracle",
                  file=sys.stderr)
    if args.events:
        Path(args.events).write_text(json.dumps(
            [[to_doc(e) for e in trial] for trial in res.event_log]))
        out["events_path"] = args.events
    print(json.dumps(out, indent=1))
    return 1 if args.oracle and not out["oracle"]["bit_identical"] else 0


if __name__ == "__main__":
    sys.exit(main())
