#!/usr/bin/env python3
"""Cross-host shm mirror: typed result groups over DCN (ZeroMQ pub/sub).

The reference runs its GUI on the vehicle's network and reads libshm
directly; there is no remote-host story. This bridge completes the
distributed picture the TPU re-design already uses for frames
(stream_server/stream_client carry JPEG frames over zmq): a publisher on
the vehicle watches shm result groups (the seq word each Group maintains)
and ships full snapshots of any group that changed; a subscriber applies
them into its local store, auto-defining unknown groups from the schema
that rides along. A topside dashboard then reads `shm.red_buoy_results`
locally as if it were on the vehicle.

    # vehicle
    python -m cuauv_vision_pipeline_tpu_torch.misc.shm_bridge pub \
        --bind tcp://*:5801 --all
    # topside
    python -m cuauv_vision_pipeline_tpu_torch.misc.shm_bridge sub \
        --connect tcp://vehicle:5801

Full-snapshot-per-change (not field deltas): groups are tens of fields
(<1 KB JSON), the bus is latest-wins by nature, and snapshots make late
joiners and dropped messages self-healing. ``--prefix`` on the subscriber
rewrites group names (mirror_red_buoy_results) — the same-host test/demo
mode.

Port of ``cuauv_vision_pipeline_tpu.misc.shm_bridge`` with the same JSON
snapshot on the wire, so a JAX publisher feeds a port subscriber and the
other way round. ``--all`` mirrors the groups of this process's
``CUAUV_SHM_NAMESPACE`` (every group without one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from ..core import shm


def _schema_of(group: "shm.Group") -> Dict:
    """Reconstruct a declarable schema from a live group's field info."""
    snap = group.get()
    schema = {}
    for fname in group.field_names():
        value = getattr(snap, fname)
        if isinstance(value, bool):
            schema[fname] = ["bool", value]
        elif isinstance(value, int):
            schema[fname] = ["int", value]
        elif isinstance(value, float):
            schema[fname] = ["float", value]
        else:
            schema[fname] = ["string", str(value)]
    return schema


def publish(
    bind: str,
    groups: Optional[List[str]],
    all_groups: bool,
    interval_s: float = 0.005,
    rediscover_s: float = 2.0,
    duration_s: Optional[float] = None,
) -> None:
    import zmq

    ctx = zmq.Context()
    sock = ctx.socket(zmq.PUB)
    sock.bind(bind)

    attached: Dict[str, "shm.Group"] = {}
    last_seq: Dict[str, int] = {}

    def attach(names: List[str]) -> None:
        for n in names:
            if n in attached:
                continue
            try:
                attached[n] = shm.group(n)
                last_seq[n] = -1  # force an initial snapshot
            except KeyError:
                print(f"[shm_bridge] no such group: {n}", file=sys.stderr)

    explicit = groups or []
    attach(explicit if not all_groups else shm.list_groups())

    t_end = time.monotonic() + duration_s if duration_s else None
    next_scan = time.monotonic() + rediscover_s
    print(f"[shm_bridge] publishing {len(attached)} group(s) on {bind}")
    try:
        while t_end is None or time.monotonic() < t_end:
            now = time.monotonic()
            if all_groups and now >= next_scan:
                next_scan = now + rediscover_s
                attach(shm.list_groups())
            for name, group in list(attached.items()):
                try:
                    seq = group.seq
                except OSError:
                    continue
                if seq == last_seq[name]:
                    continue
                last_seq[name] = seq
                snap = vars(group.get())
                msg = {
                    "group": name,
                    "seq": seq,
                    "t_ms": int(time.time() * 1000),
                    "schema": _schema_of(group),
                    "values": snap,
                }
                sock.send_multipart(
                    [name.encode(), json.dumps(msg).encode()]
                )
            time.sleep(interval_s)
    finally:
        sock.close(0)
        ctx.term()


def subscribe(
    connect: str,
    prefix: str = "",
    duration_s: Optional[float] = None,
    groups: Optional[List[str]] = None,
) -> None:
    import zmq

    ctx = zmq.Context()
    sock = ctx.socket(zmq.SUB)
    sock.connect(connect)
    for topic in groups or [""]:
        sock.setsockopt(zmq.SUBSCRIBE, topic.encode())
    poller = zmq.Poller()
    poller.register(sock, zmq.POLLIN)

    defined = set()
    t_end = time.monotonic() + duration_s if duration_s else None
    print(f"[shm_bridge] mirroring from {connect} (prefix='{prefix}')")
    try:
        while t_end is None or time.monotonic() < t_end:
            if not poller.poll(100):
                continue
            _, payload = sock.recv_multipart()
            msg = json.loads(payload)
            name = prefix + msg["group"]
            if name not in defined:
                try:
                    shm.group(name)
                except KeyError:
                    shm.define_group(name, msg["schema"])
                defined.add(name)
            shm.group(name).set(**msg["values"])
    finally:
        sock.close(0)
        ctx.term()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="shm mirror over zmq")
    sub = parser.add_subparsers(dest="mode", required=True)

    p = sub.add_parser("pub", help="publish local shm groups")
    p.add_argument("--bind", default="tcp://*:5801")
    p.add_argument("--groups", default="", help="comma list of group names")
    p.add_argument("--all", action="store_true", help="mirror every group")
    p.add_argument("--duration", type=float, default=None)

    s = sub.add_parser("sub", help="apply remote snapshots locally")
    s.add_argument("--connect", default="tcp://localhost:5801")
    s.add_argument("--prefix", default="", help="local group name prefix")
    s.add_argument("--groups", default="", help="comma list to subscribe")
    s.add_argument("--duration", type=float, default=None)

    args = parser.parse_args(argv)
    if args.mode == "pub":
        names = [g for g in args.groups.split(",") if g]
        publish(args.bind, names, args.all, duration_s=args.duration)
    else:
        names = [g for g in args.groups.split(",") if g]
        subscribe(
            args.connect,
            prefix=args.prefix,
            duration_s=args.duration,
            groups=names or None,
        )


if __name__ == "__main__":
    main()
