"""``migrate``: convert an upstream Accelerate YAML configuration into the
launcher's schema (:mod:`.config`).

Counterpart of :mod:`accelerate_tpu.commands.migrate`, with the same
mappings and the same notes: each strategy block (``distributed_type``,
``fsdp_config``, the Megatron-LM degrees, the DeepSpeed ZeRO stage)
becomes mesh-axis sizes. The port trains on one card until ROADMAP.md
Queue 1 item 8 lands, so its launcher refuses a converted file whose
mesh is wider than one card; the conversion itself is that of the JAX
package.

Example::

    python -m accelerate_tpu_torch.commands.cli migrate upstream.yaml --output_file ours.yaml
"""

from __future__ import annotations

import os

from .config import CONFIG_KEYS, _dump_yaml, _load_yaml


def convert_reference_config(ref: dict) -> tuple[dict, list[str]]:
    """Map a reference accelerate YAML dict -> (our config dict, notes)."""
    out: dict = {}
    notes: list[str] = []

    for key in ("num_processes", "num_machines", "main_process_ip", "main_process_port",
                "tpu_name", "tpu_zone", "gradient_accumulation_steps", "debug"):
        if ref.get(key) is not None:
            out[key] = ref[key]

    mp = ref.get("mixed_precision")
    if mp and mp != "no":
        out["mixed_precision"] = mp

    dtype = str(ref.get("distributed_type", "")).upper()
    fsdp = ref.get("fsdp_config") or {}
    megatron = ref.get("megatron_lm_config") or {}
    ds = ref.get("deepspeed_config") or {}

    if "FSDP" in dtype or fsdp:
        out["mesh_fsdp"] = -1
        out["mesh_data"] = 1
        notes.append("FSDP -> mesh_fsdp=-1 (param+optimizer sharding via GSPMD; "
                     "auto-wrap/prefetch/state-dict knobs have no TPU equivalent needed)")
        if fsdp.get("fsdp_activation_checkpointing"):
            notes.append("fsdp_activation_checkpointing -> model remat flag (set remat=True on the model config)")
    elif "DEEPSPEED" in dtype or ds:
        stage = int(ds.get("zero_stage", 2))
        if stage >= 3:
            out["mesh_fsdp"] = -1
            out["mesh_data"] = 1
            notes.append(f"DeepSpeed ZeRO-{stage} -> mesh_fsdp=-1 (param sharding)")
        else:
            out["mesh_data"] = -1
            notes.append(f"DeepSpeed ZeRO-{stage} -> data mesh + shard_optimizer_state "
                         "(optimizer-state sharding over the data axis)")
        if ds.get("offload_optimizer_device") not in (None, "none"):
            notes.append("offload_optimizer_device: host offload is automatic on TPU VMs when HBM is short")
    elif "MEGATRON" in dtype or megatron:
        tp = int(megatron.get("tp_degree", 1))
        pp = int(megatron.get("pp_degree", 1))
        if tp > 1:
            out["mesh_tensor"] = tp
        if pp > 1:
            out["mesh_pipe"] = pp
        if str(megatron.get("sequence_parallelism", "")).lower() in ("true", "1"):
            out["mesh_seq"] = max(2, tp)
            notes.append("Megatron sequence_parallelism -> mesh_seq axis (ring/all-to-all context parallel)")
        out["mesh_data"] = -1
        notes.append(f"Megatron tp={tp} pp={pp} -> mesh axes (no external engine)")
    elif "TP" in dtype:
        out["mesh_tensor"] = -1
        out["mesh_data"] = 1
        notes.append("TP -> mesh_tensor (Megatron-style column/row splits ship with the model zoo)")
    else:
        out["mesh_data"] = -1
        if dtype and "NO" not in dtype:
            notes.append(f"{dtype or 'MULTI_GPU'} -> pure data parallelism (mesh_data=-1)")

    dropped = sorted(
        k for k in ref
        if k not in out and k not in ("distributed_type", "fsdp_config", "megatron_lm_config",
                                      "deepspeed_config", "mixed_precision", "compute_environment",
                                      "use_cpu", "debug")
    )
    for k in dropped:
        notes.append(f"dropped '{k}' (no TPU-side equivalent or handled automatically)")
    out = {k: v for k, v in out.items() if k in CONFIG_KEYS}
    return out, notes


def migrate_command(args) -> int:
    with open(args.config_file) as f:
        ref = _load_yaml(f.read())
    ours, notes = convert_reference_config(ref)
    text = _dump_yaml(ours)
    if args.output_file:
        if os.path.exists(args.output_file) and not args.overwrite:
            raise SystemExit(f"{args.output_file} exists; pass --overwrite to replace it")
        with open(args.output_file, "w") as f:
            f.write(text)
        print(f"wrote {args.output_file}")
    else:
        print(text)
    for note in notes:
        print(f"# note: {note}")
    return 0


def migrate_parser(subparsers):
    parser = subparsers.add_parser(
        "migrate", help="convert an upstream accelerate YAML config to this framework's schema"
    )
    parser.add_argument("config_file", help="path to the reference accelerate YAML config")
    parser.add_argument("--output_file", default=None, help="write here instead of stdout")
    parser.add_argument("--overwrite", action="store_true", help="replace an existing output file")
    parser.set_defaults(func=migrate_command)
    return parser
