"""Fleet report: render the fleet view's digest.

::

    python -m ray_tpu_torch.telemetry.fleet_report --dump aggregate.json [--json]

Counterpart of ``ray_tpu/telemetry/fleet_report.py``. ``--dump``
renders a JSON file written from
:meth:`~ray_tpu_torch.telemetry.fleetview.FleetAggregator.report_data`
(post-mortem). ``--kv HOST:PORT``, the reference's read of a live fleet
KV server, raises: the KV plane is ROADMAP.md queue 1 item 7.

Sections: per-host health (snapshot age against the staleness horizon,
seq, clock offset, KV RTT, ledger MFU), barrier and collective walls
(who arrived last, how long everyone else stood waiting), and the epoch
history where the digest carries one.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


def build_report(kv: Optional[str] = None, dump: Optional[str] = None,
                 token: Optional[str] = None) -> Dict[str, Any]:
    if dump:
        with open(dump) as f:
            report = json.load(f)
        report.setdefault("source", f"dump:{dump}")
        return report
    if kv:
        raise NotImplementedError(
            "fleet_report --kv: the fleet KV plane is not ported yet: ROADMAP.md queue 1 item 7"
        )
    raise ValueError("need --dump FILE")


def _ms(v) -> str:
    return "-" if v is None else f"{1e3 * float(v):.2f}"


def render_text(report: Dict[str, Any]) -> str:
    out: List[str] = []
    hosts = report.get("hosts") or []
    out.append(
        f"== fleet view: {report.get('source', '?')} "
        f"({len(hosts)} hosts reporting, "
        f"gen {report.get('latest_gen', '-')}) =="
    )
    out.append("")
    out.append("-- hosts --")
    out.append(
        f"{'host':20s} {'seq':>5s} {'health':>7s} {'age_s':>7s} "
        f"{'offset_ms':>10s} {'kv_rtt_ms':>10s} {'mfu%':>6s} "
        f"{'spans':>7s}"
    )
    max_age = report.get("max_age_s")
    for h in hosts:
        age = h.get("age_s")
        if age is None:
            health = "?"
            age_s = "-"
        else:
            stale = max_age is not None and age > max_age
            health = "STALE" if stale else "live"
            age_s = f"{age:.1f}"
        mfu = h.get("mfu")
        kv_rtt = h.get("kv_rtt_s")
        if kv_rtt is None:
            kv_rtt = h.get("rtt_s")
        out.append(
            f"{str(h.get('host'))[:20]:20s} "
            f"{str(h.get('seq', '-')):>5s} {health:>7s} "
            f"{age_s:>7s} {_ms(h.get('clock_offset_s')):>10s} "
            f"{_ms(kv_rtt):>10s} "
            f"{(f'{100 * mfu:.2f}' if mfu else '-'):>6s} "
            f"{str(h.get('spans_buffered', '-')):>7s}"
        )
    barriers = report.get("barriers") or []
    out.append("")
    out.append(f"-- barrier walls ({len(barriers)}) --")
    if barriers:
        out.append(
            f"{'gen':>4s} {'barrier':28s} {'kind':>10s} "
            f"{'straggler':20s} {'max_wait_ms':>12s}"
        )
    for b in barriers[-20:]:
        waits = b.get("waits") or {}
        max_wait = max(waits.values()) if waits else None
        out.append(
            f"{str(b.get('gen', '-')):>4s} "
            f"{str(b.get('name'))[:28]:28s} "
            f"{str(b.get('kind', '-')):>10s} "
            f"{str(b.get('straggler'))[:20]:20s} "
            f"{_ms(max_wait):>12s}"
        )
    epochs = report.get("epochs") or []
    out.append("")
    out.append(f"-- epoch history ({len(epochs)}) --")
    for e in epochs:
        hosts_e = e.get("hosts") or ()
        out.append(
            f"gen {e.get('gen')}: {len(hosts_e)} hosts "
            f"({', '.join(str(h) for h in hosts_e)})"
        )
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.telemetry.fleet_report",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--kv", help="live fleet KV endpoint, HOST:PORT (ROADMAP.md item 7)")
    ap.add_argument("--dump", help="FleetAggregator.report_data() JSON (post-mortem)")
    ap.add_argument("--token", help="KV auth token")
    ap.add_argument("--json", action="store_true", help="emit JSON, not text")
    args = ap.parse_args(argv)
    if not args.kv and not args.dump:
        ap.error("one of --kv or --dump is required")
    report = build_report(kv=args.kv, dump=args.dump, token=args.token)
    if args.json:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(render_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
