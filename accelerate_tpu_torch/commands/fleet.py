"""``fleet``: price KV handoffs and failovers, and demo the fleet router.

Counterpart of ``accelerate-tpu fleet`` (:mod:`accelerate_tpu.commands.fleet`),
run as ``python -m accelerate_tpu_torch.commands.fleet``.

``price-handoff`` and ``price-failover`` are host arithmetic over
:mod:`accelerate_tpu_torch.analysis.costmodel`'s card rows (the H100's by
default): the per-token KV bytes of a model's cache, the priced transfer
(a fleet's replicas share the card, so a handoff moves its rows to the
host and back: ``HANDOFF_BW_TABLE``), and the re-prefill bound the router
compares it with under ``handoff="auto"``; the JAX package's formulas.
``demo`` runs a tiny in-process fleet (on the card unless ``--device
cpu``): a shared-preamble workload over N replicas with the radix prefix
cache on, printing the merged metrics, radix stats and handoff
accounting.

Examples::

    python -m accelerate_tpu_torch.commands.fleet price-handoff --layers 22 --kv-heads 4 --head-dim 64 \\
        --dtype-bytes 2 --tokens 1280
    python -m accelerate_tpu_torch.commands.fleet price-failover --layers 22 --kv-heads 4 --head-dim 64 \\
        --prompt-tokens 1024 --generated-tokens 16 --params 1.1e9
    python -m accelerate_tpu_torch.commands.fleet demo --replicas 2 --requests 24 --format json
"""

from __future__ import annotations

import argparse
import json

#: how a handoff's rows travel between replicas of one card
TRANSPORT = "host round trip"


def fleet_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("fleet", help="Price KV handoffs / demo the multi-replica serving router")
    else:
        parser = argparse.ArgumentParser("python -m accelerate_tpu_torch.commands.fleet")
    sub = parser.add_subparsers(dest="fleet_command", required=True)

    p_price = sub.add_parser("price-handoff", help="Bytes + transfer time of one prefill->decode KV handoff")
    p_price.add_argument("--layers", type=int, required=True, help="decoder layers")
    p_price.add_argument("--kv-heads", dest="kv_heads", type=int, required=True)
    p_price.add_argument("--head-dim", dest="head_dim", type=int, required=True)
    p_price.add_argument("--dtype-bytes", dest="dtype_bytes", type=int, default=2,
                         help="bytes per cache element (2 = bf16)")
    p_price.add_argument("--tokens", type=int, required=True, help="prompt length to hand off")
    p_price.add_argument("--params", type=float, default=None,
                         help="model parameter count (enables the re-prefill comparison)")
    p_price.add_argument("--generation", default="h100", help="card row of the cost model")
    p_price.add_argument("--format", choices=("text", "json", "sarif"), default="text")
    p_price.set_defaults(fleet_func=price_handoff_command)

    p_fo = sub.add_parser("price-failover", help="Price migrating one in-flight request off a dying replica")
    p_fo.add_argument("--layers", type=int, required=True, help="decoder layers")
    p_fo.add_argument("--kv-heads", dest="kv_heads", type=int, required=True)
    p_fo.add_argument("--head-dim", dest="head_dim", type=int, required=True)
    p_fo.add_argument("--dtype-bytes", dest="dtype_bytes", type=int, default=2,
                      help="bytes per cache element (2 = bf16)")
    p_fo.add_argument("--prompt-tokens", dest="prompt_tokens", type=int, required=True)
    p_fo.add_argument("--generated-tokens", dest="generated_tokens", type=int, default=0,
                      help="tokens already generated when the replica died")
    p_fo.add_argument("--params", type=float, required=True, help="model parameter count (for the recompute arm)")
    p_fo.add_argument("--no-kv", dest="kv_exportable", action="store_false",
                      help="KV not exportable (paged/speculative/poisoned): recompute only")
    p_fo.add_argument("--generation", default="h100", help="card row of the cost model")
    p_fo.add_argument("--format", choices=("text", "json"), default="text")
    p_fo.set_defaults(fleet_func=price_failover_command)

    p_demo = sub.add_parser("demo", help="Run a tiny in-process fleet and print its metrics")
    p_demo.add_argument("--replicas", type=int, default=2)
    p_demo.add_argument("--requests", type=int, default=16)
    p_demo.add_argument("--roles", default=None, help="comma list, e.g. prefill,decode (default: all mixed)")
    p_demo.add_argument("--no-prefix-reuse", dest="prefix_reuse", action="store_false")
    p_demo.add_argument("--seed", type=int, default=0)
    p_demo.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="Where the replicas serve")
    p_demo.add_argument("--format", choices=("text", "json"), default="text")
    p_demo.set_defaults(fleet_func=demo_command)

    parser.set_defaults(func=lambda args: args.fleet_func(args))
    return parser


def price_handoff_command(args) -> int:
    from ..analysis.costmodel import prefill_compute_us, price_kv_handoff

    # K + V per layer: [heads, dim] rows of dtype_bytes each token
    per_token = 2 * args.layers * args.kv_heads * args.head_dim * args.dtype_bytes
    pred = price_kv_handoff(per_token, args.tokens, generation=args.generation)
    out = {
        "bytes_per_token": per_token,
        "tokens": args.tokens,
        "transport": TRANSPORT,
        "generation": args.generation,
        "handoff_bytes": pred["bytes"],
        "handoff_us": round(pred["time_us"], 3),
    }
    if args.params:
        alt = prefill_compute_us(int(args.params), args.tokens, generation=args.generation)
        out["reprefill_us"] = round(alt, 3)
        out["decision"] = "handoff" if pred["time_us"] <= alt else "local-prefill"
    if args.format == "sarif":
        # a handoff the router would refuse (re-prefill is cheaper) is a
        # warning: shipping those bytes anyway is the misconfiguration
        from ..analysis import render_sarif_run

        level = "warning" if out.get("decision") == "local-prefill" else "note"
        msg = (
            f"KV handoff of {args.tokens} tokens = {pred['bytes']:,} B over the {TRANSPORT} "
            f"({args.generation}): ~{out['handoff_us']} us"
        )
        if "reprefill_us" in out:
            msg += f"; re-prefill ~{out['reprefill_us']} us -> {out['decision']}"
        print(render_sarif_run("accelerate-tpu-fleet", [{
            "rule_id": "FLEET001", "name": "kv-handoff-pricing", "level": level,
            "summary": "priced prefill->decode KV handoff vs local re-prefill",
            "message": msg,
        }]))
    elif args.format == "json":
        print(json.dumps(out, indent=2))
    else:
        print(f"KV handoff: {per_token} B/token x {args.tokens} tokens = "
              f"{pred['bytes']:,} B over the {TRANSPORT} ({args.generation})")
        print(f"  transfer  ~ {out['handoff_us']} us")
        if "reprefill_us" in out:
            print(f"  re-prefill ~ {out['reprefill_us']} us  ->  {out['decision']}")
    return 0


def price_failover_command(args) -> int:
    from ..analysis.costmodel import price_failover

    per_token = 2 * args.layers * args.kv_heads * args.head_dim * args.dtype_bytes
    priced = price_failover(
        per_token, args.prompt_tokens, args.generated_tokens, int(args.params),
        generation=args.generation, kv_exportable=args.kv_exportable,
    )
    out = {
        "bytes_per_token": per_token,
        "prompt_tokens": args.prompt_tokens,
        "generated_tokens": args.generated_tokens,
        "kv_exportable": args.kv_exportable,
        "transport": TRANSPORT,
        "generation": args.generation,
        "rows": priced["rows"],
        "handoff_bytes": priced["handoff"]["bytes"],
        "handoff_us": round(priced["handoff"]["time_us"], 3),
        "recompute_us": round(priced["recompute_us"], 3),
        "path": priced["path"],
    }
    if args.format == "json":
        print(json.dumps(out, indent=2))
    else:
        print(f"failover of {priced['rows']} KV rows "
              f"({args.prompt_tokens} prompt + {args.generated_tokens} generated):")
        print(f"  KV handoff  {priced['handoff']['bytes']:,} B over the {TRANSPORT} "
              f"({args.generation}) ~ {out['handoff_us']} us"
              + ("" if args.kv_exportable else "  [unavailable: --no-kv]"))
        print(f"  recompute   ~ {out['recompute_us']} us")
        print(f"  -> router picks: {out['path']}")
    return 0


def demo_command(args) -> int:
    import numpy as np

    from ..models.llama import LlamaConfig, create_llama_model
    from ..serving_fleet import FleetConfig, FleetRouter

    model = create_llama_model(LlamaConfig.tiny(), device=args.device)
    roles = tuple(args.roles.split(",")) if args.roles else None
    n = max(args.replicas, len(roles) if roles else 0)
    router = FleetRouter.from_model(
        model, num_replicas=n,
        config=FleetConfig(roles=roles, prefix_reuse=args.prefix_reuse, min_prefix_tokens=4, promote_after=2),
        num_slots=2, prompt_buckets=(8, 16), max_len=64, device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    preamble = rng.integers(1, 200, size=12).astype(np.int32)
    uids = []
    for _ in range(args.requests):
        suffix = rng.integers(1, 200, size=int(rng.integers(2, 8))).astype(np.int32)
        uids.append(router.submit(np.concatenate([preamble, suffix]), max_new_tokens=8))
    done = router.run()
    merged = router.metrics_merged().snapshot()
    report = {
        "replicas": [r.name for r in router.replicas],
        "completed": sum(1 for u in uids if u in done),
        "merged_metrics": {k: v for k, v in merged.items() if v is not None},
        "radix": router.radix_stats(),
        "handoff": router.handoff_accounting(),
    }
    if args.format == "json":
        print(json.dumps(report, indent=2, default=float))
    else:
        print(f"fleet: {len(router.replicas)} replicas, {report['completed']}/{len(uids)} requests completed")
        m = report["merged_metrics"]
        print(f"  tokens generated: {m['tokens_generated']}  "
              f"prefix hits/misses: {m['prefix_hits']}/{m['prefix_misses']}  "
              f"preamble tokens reused: {m['prefix_tokens_reused']}")
        for name, st in report["radix"].items():
            print(f"  radix[{name}]: {st}")
        if report["handoff"]["handoffs"]:
            print(f"  handoffs: {report['handoff']}")
    return 0


def main():
    args = fleet_parser().parse_args()
    raise SystemExit(args.fleet_func(args))


if __name__ == "__main__":
    main()
