"""Command-line interface: python -m misaka_tpu_torch <command>.

The port's twin of misaka_tpu/__main__.py:

  serve                      run the master (same env contract as
                             `python -m misaka_tpu_torch.runtime.app`)
  check    <topology>        compile a topology, report per-node code sizes
  disasm   <topology>        compile then disassemble every program node
  debug    <topology>        interactive single-step debugger
                             (misaka_tpu_torch.debug), on the card unless
                             --device cpu (or MISAKA_DEVICE=cpu)
  compute  <v...> [--url]    send values to a running master's /compute
  bench    [--batch --values] quick add-2 throughput smoke: one launch of
                             the fused kernel, on the card unless --device
                             cpu (or MISAKA_DEVICE=cpu)
  replay   <segment|dir>     shadow-replay a captured .mskcap segment
                             (misaka_tpu_torch/replay.py), on the card
                             unless --device cpu (or MISAKA_DEVICE=cpu)
  usage-report [--url]       pull and verify the signed usage export
                             (GET /usage/export)

<topology> is a baseline config name (add2, acc_loop, ring4, sorter,
mesh8 -- misaka_tpu_torch/networks.py), a path to a declarative JSON file
({"nodes": {...}, "programs": {...}} -- runtime/topology.py), or a
reference docker-compose .yml whose services carry NODE_TYPE/PROGRAM envs
(runtime/compose.py; a host without PyYAML answers it with status 2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from misaka_tpu_torch import replay as replay_mod

NOT_PORTED_STATUS = 2


class NotPorted(Exception):
    """A request this host cannot serve (exit status 2)."""


def _load_topology(spec: str):
    from misaka_tpu_torch import networks
    from misaka_tpu_torch.runtime.topology import Topology

    if spec in networks.BASELINE_CONFIGS:
        return networks.BASELINE_CONFIGS[spec]()
    if spec.endswith((".yml", ".yaml")):
        # a reference docker-compose deployment file (runtime/compose.py)
        from misaka_tpu_torch.runtime.compose import load_compose

        try:
            return load_compose(spec)
        except ImportError:
            raise NotPorted(f"docker-compose topologies ({spec}) need PyYAML, "
                            "which this host lacks") from None
    with open(spec) as f:
        return Topology.from_json(f.read())


def cmd_check(args) -> int:
    try:
        top = _load_topology(args.topology)
        net = top.compile(device="cpu")  # the tables only: no card needed
    except NotPorted:
        raise
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    lanes = top.lane_ids()
    print(f"ok: {len(lanes)} program node(s), {len(top.stack_ids())} stack node(s)")
    for name, i in lanes.items():
        print(f"  {name}: {int(net.prog_len[i])} line(s)")
    return 0


def cmd_disasm(args) -> int:
    from misaka_tpu_torch.tis.disasm import disassemble_network

    top = _load_topology(args.topology)
    net = top.compile(device="cpu")
    texts = disassemble_network(
        net.code, net.prog_len, list(top.lane_ids()), list(top.stack_ids())
    )
    for name, text in texts.items():
        print(f"# --- {name} ---")
        print(text)
    return 0


def cmd_compute(args) -> int:
    import urllib.error

    from misaka_tpu_torch.client import MisakaClient, MisakaClientError

    client = MisakaClient(args.url, timeout=args.timeout)
    for v in args.values:
        try:
            print(json.dumps({"value": client.compute(v)}))
        except MisakaClientError as e:
            print(f"error: {e.body}", file=sys.stderr)
            return 1
        except urllib.error.URLError as e:
            print(f"error: cannot reach {args.url}: {e.reason}", file=sys.stderr)
            return 1
    return 0


def bench_ticks(per: int) -> int:
    """`bench`'s tick count for `per` values an instance: add-2 retires one
    value per ~12-14 ticks."""
    return 14 * per + 64


def bench_setup(batch: int, per: int, device=None):
    """(network, state, values) of `bench`: add-2 at `batch` instances with
    each input ring filled from default_rng(0), int32 in [-1000, 1000)."""
    import numpy as np
    import torch

    from misaka_tpu_torch import networks

    net = networks.add2(in_cap=per, out_cap=per, stack_cap=16).compile(batch=batch,
                                                                       device=device)
    vals = np.random.default_rng(0).integers(-1000, 1000, (batch, per)).astype(np.int32)
    state = net.init_state()._replace(
        in_buf=torch.tensor(vals, device=net.device),
        in_wr=torch.full((batch,), per, dtype=torch.int32, device=net.device),
    )
    return net, state, vals


def cmd_bench(args) -> int:
    """Quick engine-path throughput smoke on the add-2 network: the run is
    one launch of the fused kernel on the card (its plain version on the
    CPU).  The timed window holds the run, with the wrapper's checks and
    clones, and the read of out_wr, as the JAX CLI's holds its run and
    that read."""
    import time

    import numpy as np
    import torch

    batch, per = args.batch, args.values
    net, state, vals = bench_setup(batch, per, args.device)
    ticks = bench_ticks(per)
    run = net.fused_runner(ticks, elide_dead_hi=False)  # builds the kernel on the card
    # Warm up on a throwaway state, and wait for it, or the asynchronous
    # launch would bleed into the timed window below.
    run(net.init_state())
    if net.device.type == "cuda":
        torch.cuda.synchronize(net.device)
    t0 = time.perf_counter()
    state = run(state)
    out_wr = state.out_wr.cpu().numpy()
    dt = time.perf_counter() - t0
    if not (out_wr == per).all():
        print(f"error: only {int(out_wr.min())}/{per} outputs after {ticks} ticks",
              file=sys.stderr)
        return 1
    got = state.out_buf.cpu().numpy()
    if not (np.sort(got, axis=1) == np.sort(vals + 2, axis=1)).all():
        print("error: output mismatch", file=sys.stderr)
        return 1
    rate = batch * per / dt
    print(json.dumps({"metric": "add2_cli_smoke", "value": round(rate, 1),
                      "unit": "inputs/sec"}))
    return 0


def cmd_usage_report(args) -> int:
    """Pull the signed usage export from a server, verify every line when
    a secret is at hand, and print the per-program totals."""
    import urllib.error

    from misaka_tpu_torch.client import MisakaClient, MisakaClientError
    from misaka_tpu_torch.runtime import usage as usage_mod

    client = MisakaClient(args.url, timeout=args.timeout, api_key=args.key)
    try:
        lines = client.usage_export(since=args.since)
    except MisakaClientError as e:
        print(f"error: {e.body}", file=sys.stderr)
        return 1
    except urllib.error.URLError as e:
        print(f"error: cannot reach {args.url}: {e.reason}", file=sys.stderr)
        return 1
    if args.raw:
        for line in lines:
            print(json.dumps(line, separators=(",", ":")))
        return 0
    try:
        totals = usage_mod.totals_from_lines(
            lines, secret=args.secret.encode() if args.secret else None)
    except usage_mod.UsageExportError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(totals, indent=2, sort_keys=True))
    if args.secret and not totals.get("verified"):
        print("error: export carried no signed lines to verify", file=sys.stderr)
        return 1
    return 0


def cmd_debug(args) -> int:
    from misaka_tpu_torch.debug import Debugger

    top = _load_topology(args.topology)
    dbg = Debugger(top, device=args.device)
    lanes = list(top.lane_ids())
    print(f"misaka_tpu_torch debugger — lanes: {', '.join(lanes)} (type 'help')")
    while True:
        try:
            line = input("(mdb) ").strip()
        except EOFError:
            return 0
        if not line:
            continue
        cmd, *rest = line.split()
        try:
            if cmd in ("q", "quit", "exit"):
                return 0
            elif cmd == "help":
                print(
                    "step [n]         advance n ticks (default 1)\n"
                    "run [n]          run until breakpoint (budget n, default 10000)\n"
                    "break LANE LINE  set a breakpoint\n"
                    "clear            clear all breakpoints\n"
                    "feed V [V...]    queue input values\n"
                    "out              drain outputs\n"
                    "print LANE       show a lane's registers/ports\n"
                    "stacks           show stack contents\n"
                    "list LANE        disassembly with pc cursor\n"
                    "trace [n]        recent execution history\n"
                    "reset            reset all state\n"
                    "quit             exit"
                )
            elif cmd == "step":
                hits = dbg.step(int(rest[0]) if rest else 1)
                print(f"tick={dbg.tick}" + (f" BREAK {hits}" if hits else ""))
            elif cmd == "run":
                hits = dbg.run(int(rest[0]) if rest else 10_000)
                print(f"tick={dbg.tick}" + (f" BREAK {hits}" if hits else " (no hit)"))
            elif cmd == "break":
                dbg.add_breakpoint(rest[0], int(rest[1]))
                print(f"breakpoint at {rest[0]}:{rest[1]}")
            elif cmd == "clear":
                dbg.clear_breakpoints()
            elif cmd == "feed":
                took = dbg.feed([int(v) for v in rest])
                print(f"queued {took}")
            elif cmd == "out":
                print(dbg.outputs())
            elif cmd == "print":
                print(json.dumps(dbg.inspect(rest[0]), indent=2))
            elif cmd == "stacks":
                print(json.dumps(dbg.stacks()))
            elif cmd == "list":
                print(dbg.listing(rest[0]))
            elif cmd == "trace":
                print(dbg.history(int(rest[0]) if rest else 16))
            elif cmd == "reset":
                dbg.reset()
                print("reset")
            else:
                print(f"unknown command '{cmd}' (try 'help')")
        except (KeyError, ValueError, IndexError) as e:
            print(f"error: {e}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="misaka_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("serve", help="run the master from env vars")
    p = sub.add_parser("check", help="compile a topology")
    p.add_argument("topology")
    p = sub.add_parser("disasm", help="disassemble a topology's programs")
    p.add_argument("topology")
    p = sub.add_parser("debug", help="interactive debugger")
    p.add_argument("topology")
    p.add_argument("--device", default=os.environ.get("MISAKA_DEVICE") or None,
                   help="cuda (default) or cpu")
    p = sub.add_parser("compute", help="POST values to a running master")
    p.add_argument("values", nargs="+", type=int)
    p.add_argument("--url", default="http://localhost:8000")
    p.add_argument("--timeout", type=float, default=60.0)
    p = sub.add_parser("bench", help="quick add-2 throughput smoke")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--values", type=int, default=32)
    p.add_argument("--device", default=os.environ.get("MISAKA_DEVICE") or None,
                   help="cuda (default) or cpu")
    p = sub.add_parser("replay", help="shadow-replay a captured .mskcap segment")
    replay_mod.add_arguments(p)
    p = sub.add_parser("usage-report",
                       help="pull + verify the signed billing export (GET /usage/export)")
    p.add_argument("--url", default="http://localhost:8000")
    p.add_argument("--since", type=float, default=0.0,
                   help="unix seconds lower bound on exported periods")
    p.add_argument("--key", help="admin API key (the route is admin-gated)")
    p.add_argument("--secret", help="plane secret to verify every line's HMAC")
    p.add_argument("--raw", action="store_true",
                   help="print the JSONL lines verbatim instead of totals")
    p.add_argument("--timeout", type=float, default=60.0)
    args = parser.parse_args(argv)
    if args.command == "serve":
        from misaka_tpu_torch.runtime.app import main as serve_main

        serve_main()
        return 0
    try:
        return {"check": cmd_check, "disasm": cmd_disasm, "debug": cmd_debug,
                "compute": cmd_compute, "bench": cmd_bench, "replay": replay_mod.run,
                "usage-report": cmd_usage_report}[args.command](args)
    except NotPorted as e:
        print(f"error: {e}", file=sys.stderr)
        return NOT_PORTED_STATUS


if __name__ == "__main__":
    sys.exit(main())
