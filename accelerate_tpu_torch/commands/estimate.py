"""``estimate-memory``: what a model needs in device memory.

Counterpart of :mod:`accelerate_tpu.commands.estimate`. It never builds a
model: the parameter count comes from a local safetensors file or
directory (headers only), a literal count (``7B``, ``124M``, ``350000``),
or a Hub repo id, read from the local Hugging Face cache (headers, else
the index's ``total_size``) and, only where ``huggingface_hub`` is
installed and a network is reachable, from the safetensors metadata the
Hub serves. It prints per-dtype totals for inference and for AdamW
training (f32 masters, gradients and two moments), each divided across
``--num_devices``, and whether each fits a device of ``--hbm_gb``: by
default this card's ``total_memory``, or without a card the H100 SXM's 80
GB (NVIDIA's data sheet; a figure for that card, not a measurement).

``--jaxpr`` (the JAX package's traced per-device peak) stands on the
flight check, ROADMAP.md Queue 1 item 11, and raises until it lands.

Example::

    python -m accelerate_tpu_torch.commands.cli estimate-memory 1.1B
    python -m accelerate_tpu_torch.commands.cli estimate-memory path/to/model_dir --num_devices 1
"""

from __future__ import annotations

import argparse
import json
import os

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "float8": 1}


def count_params_from_safetensors(path: str) -> int:
    """Read tensor shapes from safetensors headers (no data loaded)."""
    import struct

    total = 0
    files = []
    if os.path.isdir(path):
        files = [os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")]
    elif path.endswith(".safetensors"):
        files = [path]
    for file in files:
        with open(file, "rb") as f:
            header_len = struct.unpack("<Q", f.read(8))[0]
            header = json.loads(f.read(header_len))
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            n = 1
            for d in meta["shape"]:
                n *= d
            total += n
    return total


def _repo_id_like(text: str) -> bool:
    """``org/name`` shape that is not a local path and not a param count.
    A ``.safetensors`` suffix always means a (missing) local file — routing
    it to the Hub would turn a path typo into a network timeout."""
    import re

    return bool(re.fullmatch(r"[\w.\-]+/[\w.\-]+", text)) and not text.endswith(".safetensors")


def count_params_from_hub(repo_id: str, token=None) -> tuple[int, str]:
    """Parameter count for a Hub repo without downloading weights or
    building a model. Returns ``(count, how)``.

    Resolution order — offline-first so the zero-egress/airgapped case
    works transparently:

    1. local HF cache snapshot (``snapshot_download(local_files_only=True)``):
       safetensors headers if weights are cached, else
       ``model.safetensors.index.json`` ``total_size`` / dtype width;
    2. ``get_safetensors_metadata``: the Hub serves safetensors headers by
       ranged requests, a few KB for any model size (needs a network).
    """
    try:
        from huggingface_hub import snapshot_download

        path = snapshot_download(repo_id, local_files_only=True)
        n = count_params_from_safetensors(path)
        if n:
            return n, "local cache (safetensors headers)"
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                meta = json.load(f)
            total_bytes = meta.get("metadata", {}).get("total_size")
            if total_bytes:
                bytes_per = 2  # safetensors LLM checkpoints are bf16/fp16 by default
                cfg_path = os.path.join(path, "config.json")
                if os.path.exists(cfg_path):
                    with open(cfg_path) as f:
                        dtype = json.load(f).get("torch_dtype", "bfloat16")
                    bytes_per = DTYPE_BYTES.get(dtype, 2)
                return total_bytes // bytes_per, f"local cache (index total_size / {bytes_per}B)"
    except Exception:  # noqa: BLE001 — any cache miss falls through to the network
        pass
    try:
        from huggingface_hub import get_safetensors_metadata

        meta = get_safetensors_metadata(repo_id, token=token)
        return sum(meta.parameter_count.values()), "hub safetensors metadata"
    except Exception as e:  # noqa: BLE001 — surface one actionable message
        raise RuntimeError(
            f"could not resolve `{repo_id}` from the local HF cache or the Hub "
            f"({type(e).__name__}: {e}). Offline alternatives: pass a local "
            "safetensors path, or a parameter count like `7B`."
        ) from e


def estimate_table(num_params: int, mesh_devices: int = 1, training: bool = True) -> list[dict]:
    rows = []
    for dtype, bytes_per in DTYPE_BYTES.items():
        weights = num_params * bytes_per
        # Adam training state: fp32 master + grads + 2 moments (fp32)
        train = weights + num_params * 4 * 3 if training else None
        rows.append(
            {
                "dtype": dtype,
                "params": num_params,
                "inference_bytes": weights,
                "training_bytes": train,
                "inference_per_device": weights / mesh_devices,
                "training_per_device": (train / mesh_devices) if train else None,
            }
        )
    return rows


def _human(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} PB"


def estimate_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("estimate-memory", help="Estimate device memory requirements")
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch estimate-memory")
    parser.add_argument(
        "source",
        help="safetensors file/dir, a Hub repo id like meta-llama/Llama-3.2-1B "
        "(resolved metadata-only), or a parameter count like 7B / 124M / 350000",
    )
    parser.add_argument("--num_devices", type=int, default=1, help="mesh size to divide across")
    parser.add_argument("--inference_only", action="store_true")
    parser.add_argument(
        "--hbm_gb", type=float, default=None,
        help="per-device memory (GiB) for the fit column; default: this card's total_memory, or without a card "
        "the H100 SXM's 80 GB (NVIDIA's data sheet)",
    )
    parser.add_argument("--token", default=None, help="Hub token for gated/private repos")
    parser.add_argument(
        "--jaxpr",
        action="store_true",
        help="treat SOURCE as a step function and report its traced per-device peak: "
        "not ported (ROADMAP.md Queue 1 item 11)",
    )
    parser.add_argument("--arg", action="append", default=[], help="(--jaxpr) sample arg spec like f32[8,128]")
    parser.add_argument("--mesh", default=None, help="(--jaxpr) mesh shape, e.g. data=4,tensor=2")
    parser.add_argument("--donate", default="", help="(--jaxpr) comma-separated donated argnums")
    if subparsers is not None:
        parser.set_defaults(func=estimate_command)
    return parser


def parse_param_count(text: str) -> int:
    text = text.strip().upper()
    mult = 1
    if text.endswith("B"):
        mult, text = 10**9, text[:-1]
    elif text.endswith("M"):
        mult, text = 10**6, text[:-1]
    elif text.endswith("K"):
        mult, text = 10**3, text[:-1]
    return int(float(text) * mult)


def device_memory_gb() -> float:
    """The fit column's default: this card's memory in GiB, or without a
    card the H100 SXM's 80 GB."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory / 1024**3
    return 80.0


def estimate_command(args) -> int:
    if getattr(args, "jaxpr", False):
        raise NotImplementedError(
            "estimate-memory --jaxpr stands on the flight check (analysis/flightcheck.py), which is not ported to "
            "accelerate_tpu_torch yet (ROADMAP.md Queue 1 item 11)"
        )
    how = None
    if os.path.exists(args.source):
        num_params = count_params_from_safetensors(args.source)
    elif _repo_id_like(args.source):
        num_params, how = count_params_from_hub(args.source, token=getattr(args, "token", None))
    else:
        num_params = parse_param_count(args.source)
    rows = estimate_table(num_params, args.num_devices, training=not args.inference_only)
    via = f" (via {how})" if how else ""
    print(f"Memory estimate for {num_params:,} parameters over {args.num_devices} device(s){via}:")
    hbm_gb = args.hbm_gb if getattr(args, "hbm_gb", None) is not None else device_memory_gb()
    hbm = hbm_gb * 1024**3
    print(f"fits/device against {hbm_gb:.2f} GiB per device")
    header = (
        f"{'dtype':>10} | {'inference':>12} | {'train(Adam)':>12} | {'inf/device':>12} | "
        f"{'train/device':>12} | {'fits/device':>11}"
    )
    print(header)
    print("-" * len(header))
    for r in rows:
        per_dev = r["training_per_device"] if r["training_per_device"] is not None else r["inference_per_device"]
        fits = "yes" if per_dev <= hbm else "no"
        print(
            f"{r['dtype']:>10} | {_human(r['inference_bytes']):>12} | {_human(r['training_bytes']):>12} | "
            f"{_human(r['inference_per_device']):>12} | {_human(r['training_per_device']):>12} | {fits:>11}"
        )
    return 0


def main():
    raise SystemExit(estimate_command(estimate_parser().parse_args()))


if __name__ == "__main__":
    main()
