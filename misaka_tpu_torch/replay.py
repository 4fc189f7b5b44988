"""Shadow-replay a captured traffic segment against a (candidate) program.

The port's copy of tools/replay.py, the offline half of the capture plane
(runtime/capture.py): given a `.mskcap` segment from POST
/captures/export (written by either package), rebuild each program's
engine from its anchor checkpoint on the card, drive the recorded request
stream through it in recorded order, and compare every response byte for
byte.  Unchanged semantics must replay green; a divergence prints one line
per request (trace ID, stream offset, expected against actual head) and
the exit status is 1.  The same verdict as the in-process
`POST /programs?verify=replay` gate, runnable on any machine.

  python -m misaka_tpu_torch replay capture.mskcap
      replay every anchored program against its own recorded topology
  python -m misaka_tpu_torch replay capture.mskcap --candidate new.json --program default
      replay one program's stream against a candidate topology restored
      from the old anchor state: the pre-deploy verdict
  python -m misaka_tpu_torch replay capture.mskcap --emit-model load.json
      also fit the capture into a load model (arrival rate, sizes, mix)

The shadow runs on the card unless `--device cpu` (or MISAKA_DEVICE=cpu)
asks for the CPU, through the engine the port picks there (the fused
kernel on a card; on the CPU the host C++ tier, or the kernel's plain
version where `auto` keeps it: all bit-exact, as the reference's engine
ladder is) unless `--engine` names one.  A
directory sweeps every segment in it oldest-first.
"""

from __future__ import annotations

import json
import os
import sys


def _load_anchor(path: str):
    from misaka_tpu_torch.runtime.capture import load_anchor_checkpoint

    return load_anchor_checkpoint(path)


def _topology_from_meta(meta: dict):
    from misaka_tpu_torch.runtime.topology import Topology

    return Topology(
        node_info=meta["nodes"],
        programs=meta["programs"],
        stack_cap=int(meta["stack_cap"]),
        in_cap=int(meta["in_cap"]),
        out_cap=int(meta["out_cap"]),
    )


def _resolve_anchor_path(segment: str, info: dict, label: str) -> str:
    fname = info.get("file") or f"{os.path.basename(segment)}.anchor.{label}.npz"
    return os.path.join(os.path.dirname(os.path.abspath(segment)), fname)


def _write_model(model: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(model, f, indent=2)
        f.write("\n")


def replay_segment(
    segment: str,
    candidate: str | None = None,
    program: str | None = None,
    engine: str | None = None,
    limit: int | None = None,
    emit_model: str | None = None,
    out=None,
    device: str | None = None,
) -> int:
    """Drive a segment; returns a process exit code (0 green, 1 diverged,
    2 unusable segment or anchor).  `out` (default: the current stdout)
    takes the report lines."""
    from misaka_tpu_torch.runtime import capture
    from misaka_tpu_torch.runtime.master import MasterNode

    out = out or sys.stdout
    try:
        header, recs = capture.read_segment(segment, verify=True)
    except capture.CaptureError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    anchors = header.get("anchors") or {}
    labels = [program] if program else sorted(anchors)
    if program and program not in anchors:
        print(f"error: segment has no anchor for program {program!r} "
              f"(anchored: {', '.join(sorted(anchors)) or 'none'})", file=sys.stderr)
        return 2
    if candidate and len(labels) != 1:
        print("error: --candidate needs exactly one program (pass --program)",
              file=sys.stderr)
        return 2
    if not labels:
        print("error: segment carries no anchors (was the capture started while serving?)",
              file=sys.stderr)
        return 2

    candidate_topo = None
    if candidate:
        from misaka_tpu_torch.__main__ import NotPorted, _load_topology

        try:
            candidate_topo = _load_topology(candidate)
        except NotPorted as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    rc = 0
    for label in labels:
        info = anchors[label]
        lost = int(info.get("dropped_since_anchor") or 0)
        if lost:
            print(f"{label}: UNSOUND — the ring evicted {lost} records since the anchor; "
                  "a replay of this segment cannot prove anything (raise MISAKA_CAPTURE_MB)",
                  file=sys.stderr)
            rc = max(rc, 2)
            continue
        apath = _resolve_anchor_path(segment, info, label)
        try:
            meta, state = _load_anchor(apath)
        except Exception as e:
            print(f"{label}: error: anchor {apath}: {e}", file=sys.stderr)
            rc = max(rc, 2)
            continue
        if candidate_topo is not None:
            # the candidate inherits the anchor's capacities, as a registry
            # hot swap inherits the running registry's: caps shape the state
            from misaka_tpu_torch.runtime.topology import Topology

            topo = Topology(node_info=dict(candidate_topo.node_info),
                            programs=dict(candidate_topo.programs),
                            stack_cap=int(meta["stack_cap"]), in_cap=int(meta["in_cap"]),
                            out_cap=int(meta["out_cap"]))
        else:
            topo = _topology_from_meta(meta)
        sel = capture.replayable([r for r in recs if r["program"] == label])
        if limit is not None:
            sel = sel[-limit:]
        if not sel:
            print(f"{label}: no replayable records in segment", file=out)
            continue
        master = MasterNode(topo, batch=meta.get("batch"), engine=engine or "auto",
                            device=device)
        try:
            try:
                master.restore(state)
            except ValueError as e:
                print(f"{label}: DIVERGENCE — candidate cannot restore the capture "
                      f"anchor: {e}", file=out)
                rc = max(rc, 1)
                continue
            master.run()
            diffs = capture.replay_records(master, sel)
        finally:
            master.close()
        if diffs:
            for d in diffs:
                print(capture.format_diff(d), file=out)
            print(f"{label}: DIVERGED on {len(diffs)}/{len(sel)} captured requests", file=out)
            rc = max(rc, 1)
        else:
            print(f"{label}: replay green — {len(sel)} requests byte-for-byte identical",
                  file=out)

    if emit_model:
        try:
            model = capture.fit_load_model(recs)
        except capture.CaptureError as e:
            print(f"error: {e}", file=sys.stderr)
            return max(rc, 2)
        _write_model(model, emit_model)
        print(f"load model written to {emit_model} (rate={model['arrival']['rate_rps']} rps, "
              f"p50 n={model['values']['p50']})", file=out)
    return rc


def replay_directory(
    directory: str,
    candidate: str | None = None,
    program: str | None = None,
    engine: str | None = None,
    limit: int | None = None,
    emit_model: str | None = None,
    out=None,
    device: str | None = None,
) -> int:
    """Sweep every .mskcap segment of a directory oldest-first: the worst
    verdict wins, and `emit_model` fits one model from all their records."""
    from misaka_tpu_torch.runtime import capture

    out = out or sys.stdout

    try:
        names = sorted(os.listdir(directory))
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    segs = [os.path.join(directory, n) for n in names if n.endswith(".mskcap")]
    if not segs:
        print(f"error: no .mskcap segments under {directory}", file=sys.stderr)
        return 2
    rc = 0
    all_recs: list = []
    for seg in segs:
        print(f"== {seg}", file=out)
        rc = max(rc, replay_segment(seg, candidate=candidate, program=program, engine=engine,
                                    limit=limit, emit_model=None, out=out, device=device))
        if emit_model:
            try:
                all_recs.extend(capture.read_segment(seg, verify=True)[1])
            except capture.CaptureError:
                pass
    print(f"swept {len(segs)} segment(s): {'green' if rc == 0 else 'NOT green'}", file=out)
    if emit_model:
        try:
            model = capture.fit_load_model(all_recs)
        except capture.CaptureError as e:
            print(f"error: {e}", file=sys.stderr)
            return max(rc, 2)
        _write_model(model, emit_model)
        print(f"load model written to {emit_model} from {len(segs)} segment(s) "
              f"(rate={model['arrival']['rate_rps']} rps)", file=out)
    return rc


def add_arguments(p) -> None:
    """The replay options (the reference's, plus --device)."""
    p.add_argument("segment", help=".mskcap segment from /captures/export, or a directory "
                   "of segments to sweep oldest-first")
    p.add_argument("--candidate", help="candidate topology (baseline name, .json, or "
                   "compose .yml) to replay against")
    p.add_argument("--program", help="replay only this program label")
    p.add_argument("--engine", help="engine override (auto/scan/fused)")
    p.add_argument("--limit", type=int, help="replay only the last N records")
    p.add_argument("--emit-model", metavar="OUT.json", help="also fit a load model")
    p.add_argument("--device", default=os.environ.get("MISAKA_DEVICE") or None,
                   help="cuda (default) or cpu")


def run(args) -> int:
    fn = replay_directory if os.path.isdir(args.segment) else replay_segment
    return fn(args.segment, candidate=args.candidate, program=args.program,
              engine=args.engine, limit=args.limit, emit_model=args.emit_model,
              device=args.device)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_arguments(p)
    return run(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
