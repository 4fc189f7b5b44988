"""Process entrypoint: serve one network over HTTP.

    python -m misaka_tpu_torch.runtime.app

The port's twin of misaka_tpu/runtime/app.py for NODE_TYPE=master.
Environment:

  NODE_INFO          {"name": {"type": "program"|"stack"}, ...} (app.go:30-35)
  MISAKA_PROGRAMS    {"name": "<TIS source>", ...} per program node
  MISAKA_PORT        HTTP port (default 8000)
  MISAKA_BATCH       run N independent instances in lockstep and serve
                     concurrent requests across them (default, or 0: one
                     instance, every /compute strictly FIFO)
  MISAKA_CHUNK_STEPS ticks per device-loop chunk (default 128)
  MISAKA_ENGINE      auto (default: the fused kernel on the card, its plain
                     version on the CPU) | scan (the plain version) | fused
                     (require the kernel: batched and untraced); native
                     (the reference's host C++ tier, ROADMAP A.5) and
                     fused-interpret refuse to start, gather needs model
                     parallel
  MISAKA_TRACE_CAP   N > 0 records every tick of one instance in an N-tick
                     ring: GET /debug/isa_trace?last=N (the plain version
                     serves, recording; 409 on that route without it)
  MISAKA_TRACE_INSTANCE  which instance a batched traced server records
                     (default 0; out of range refuses to start)
  MISAKA_STACK_CAP / MISAKA_IN_CAP / MISAKA_OUT_CAP   stack and ring depths
  MISAKA_AUTORUN     "1" starts the network at boot
  MISAKA_DEVICE      cuda (default) | cpu -- with no card and no
                     MISAKA_DEVICE=cpu the app refuses to start
  MISAKA_SERVE_BATCH "0" turns the serve scheduler off: /compute and the
                     spread lanes then stripe per request (compute_spread)
  MISAKA_BATCH_WINDOW_US / MISAKA_BATCH_MAX / MISAKA_BATCH_PASSES /
  MISAKA_LANE_SMALL  the serve scheduler's knobs (runtime/master.py)
  MISAKA_STACK_AUTOGROW  "0" leaves a full stack parked; by default its
                     capacity doubles when a request stalls on it
  MISAKA_CHECKPOINT_DIR  enables POST /checkpoint and /restore, storing
                     named .npz snapshots (the JAX package's format) here
  MISAKA_FUSED_ELIDE_HI  "1" serves through the kernel's elided variant
                     (lanes with no 64-bit reader skip the hi plane)
  MISAKA_DATA_PARALLEL   shard the batch over N devices, one kernel launch
                     per shard per chunk (MISAKA_BATCH must divide by N): the
                     first N cards, and the app refuses to start when the
                     host has fewer; with MISAKA_DEVICE=cpu, N shards on the
                     CPU.  /status then reports "mesh"
  MISAKA_MODEL_PARALLEL  > 1 (lanes sharded across devices) is not ported:
                     the app refuses to start
"""

from __future__ import annotations

import json
import logging
import os

from misaka_tpu_torch.runtime.master import MasterNode, make_http_server
from misaka_tpu_torch.runtime.topology import Topology

log = logging.getLogger("misaka_tpu_torch.app")


def build_topology_from_env(environ=os.environ) -> Topology:
    caps = {}
    for env_name, field in (
        ("MISAKA_STACK_CAP", "stack_cap"),
        ("MISAKA_IN_CAP", "in_cap"),
        ("MISAKA_OUT_CAP", "out_cap"),
    ):
        v = environ.get(env_name)
        if v:
            caps[field] = int(v)
    node_info = environ.get("NODE_INFO")
    if not node_info:
        raise SystemExit("set NODE_INFO (reference JSON shape)")
    programs = json.loads(environ.get("MISAKA_PROGRAMS", "{}"))
    return Topology.from_node_info_json(node_info, programs, **caps)


def build_master_from_env(environ=os.environ) -> MasterNode:
    node_type = environ.get("NODE_TYPE", "master")
    if node_type != "master":
        raise SystemExit(f"'{node_type}' not a valid node type for this server")
    return MasterNode(
        build_topology_from_env(environ),
        chunk_steps=int(environ.get("MISAKA_CHUNK_STEPS", "0") or 0) or 128,
        trace_cap=int(environ.get("MISAKA_TRACE_CAP", "0") or 0) or None,
        batch=int(environ.get("MISAKA_BATCH", "0") or 0) or None,
        engine=environ.get("MISAKA_ENGINE", "auto"),
        trace_instance=int(environ.get("MISAKA_TRACE_INSTANCE", "0") or 0),
        device=environ.get("MISAKA_DEVICE") or None,
        # intStack.go:9-45 is unbounded: capacity grows on a wedge
        stack_autogrow=environ.get("MISAKA_STACK_AUTOGROW", "1") != "0",
        data_parallel=int(environ.get("MISAKA_DATA_PARALLEL", "0") or 0) or None,
        model_parallel=int(environ.get("MISAKA_MODEL_PARALLEL", "0") or 0) or None,
    )


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    environ = os.environ
    master = build_master_from_env(environ)
    port = int(environ.get("MISAKA_PORT", "8000"))
    httpd = make_http_server(master, port=port,
                             checkpoint_dir=environ.get("MISAKA_CHECKPOINT_DIR") or None)
    log.info("serving on :%d (engine=%s)", httpd.server_address[1], master.engine_name)
    if environ.get("MISAKA_AUTORUN") == "1":
        master.run()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        master.close()


if __name__ == "__main__":
    main()
