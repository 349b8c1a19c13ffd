"""Trace-query service launcher.

    PYTHONPATH=src python -m repro_torch.launch.trace_serve \
        --host 127.0.0.1 --port 8731 --max-handles 8 \
        --per-tenant 4 --tenant-quota 32

Mirrors :mod:`repro.launch.trace_serve`.  Starts the multi-tenant
trace-query server (:mod:`repro_torch.serving.tracequery`): pooled
pack-backed handles whose ops run on ``--device`` (the card by default;
``--device cpu`` runs the kernels' plain versions), the shared plan cache
with per-tenant quotas, single-flight plan coalescing, and admission on
the shared scheduler's interactive and bulk lanes.  ``--port 0`` binds a
free port; ``--announce`` prints one ``SERVING {"host": ..., "port": ...,
"device": ...}`` line once the socket is live.  Stop with SIGINT or
``POST /shutdown`` (a graceful drain).
"""

from __future__ import annotations

import argparse


def main():
    ap = argparse.ArgumentParser(
        description="multi-tenant trace-query service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8731,
                    help="listen port (0 = pick a free port)")
    ap.add_argument("--device", default="cuda",
                    help='where the ops run: "cuda" (default) or "cpu"')
    ap.add_argument("--announce", action="store_true",
                    help='print "SERVING {json}" once bound')
    ap.add_argument("--max-handles", type=int, default=8,
                    help="open trace handles kept warm (LRU)")
    ap.add_argument("--max-active", type=int, default=32,
                    help="queries admitted at once, all tenants")
    ap.add_argument("--per-tenant", type=int, default=4,
                    help="concurrent queries per tenant")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="plan-cache entries per tenant (default: no cap)")
    ap.add_argument("--cache-entries", type=int, default=None,
                    help="global plan-cache LRU bound")
    ap.add_argument("--workers", type=int, default=None,
                    help="total execution threads (default: CPU count)")
    ap.add_argument("--interactive-workers", type=int, default=None,
                    help="threads reserved for the interactive lane")
    args = ap.parse_args()

    from ..core.scheduler import Scheduler, set_scheduler
    from ..serving.tracequery import serve

    if args.workers is not None or args.interactive_workers is not None:
        set_scheduler(Scheduler(workers=args.workers,
                                interactive_workers=args.interactive_workers))

    try:
        serve(host=args.host, port=args.port, announce=args.announce,
              device=args.device, max_handles=args.max_handles,
              max_active=args.max_active, per_tenant=args.per_tenant,
              tenant_quota=args.tenant_quota,
              cache_entries=args.cache_entries)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
