"""``config``: the launcher's YAML configuration file.

Counterpart of :mod:`accelerate_tpu.commands.config`, with the same
schema (``CONFIG_KEYS``), reader, writer, legacy-key migration
(``--update``) and questionnaire, so a file written by either package
loads to the same dict in both. The default file is the port's own,
``$ACCELERATE_TPU_TORCH_HOME/default_config.yaml`` (else
``~/.cache/accelerate_tpu_torch/default_config.yaml``): a configuration
written for the JAX package does not steer the port's launcher.

Example::

    python -m accelerate_tpu_torch.commands.cli config --default
    python -m accelerate_tpu_torch.commands.cli config --update --config_file old.yaml
"""

from __future__ import annotations

import argparse
import json
import os

CONFIG_KEYS = {
    "num_processes": int,
    "num_machines": int,
    "machine_rank": int,
    "mixed_precision": str,
    "mesh_data": int,
    "mesh_fsdp": int,
    "mesh_tensor": int,
    "mesh_seq": int,
    "mesh_pipe": int,
    "mesh_expert": int,
    "main_process_ip": str,
    "main_process_port": int,
    "tpu_name": str,
    "tpu_zone": str,
    "tpu_hosts": str,
    "gradient_accumulation_steps": int,
    "debug": bool,
}


def default_config_path() -> str:
    """The port's default configuration file."""
    home = os.environ.get("ACCELERATE_TPU_TORCH_HOME", os.path.expanduser("~/.cache/accelerate_tpu_torch"))
    return os.path.join(home, "default_config.yaml")


def _dump_yaml(config: dict) -> str:
    try:
        import yaml

        return yaml.safe_dump(config, sort_keys=True)
    except ImportError:
        return json.dumps(config, indent=2, sort_keys=True)


def _load_yaml(text: str) -> dict:
    try:
        import yaml

        return yaml.safe_load(text) or {}
    except ImportError:
        return json.loads(text)


def load_config(path: str) -> dict:
    """The file's known keys, each cast to its schema type; unknown keys
    and nulls are left out."""
    with open(path) as f:
        config = _load_yaml(f.read())
    out = {}
    for key, value in config.items():
        if key in CONFIG_KEYS and value is not None:
            caster = CONFIG_KEYS[key]
            out[key] = bool(value) if caster is bool else caster(value)
    return out


def save_config(config: dict, path: str | None = None) -> str:
    path = path or default_config_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(_dump_yaml(config))
    return path


def interactive_config() -> dict:
    """The questionnaire; the choice questions go through the menu
    (:mod:`.menu`)."""
    from .menu import select

    config = {}

    def ask(key, prompt, default, caster=str):
        raw = input(f"{prompt} [{default}]: ").strip()
        config[key] = caster(raw) if raw else default

    ask("num_machines", "How many machines?", 1, int)
    config["mixed_precision"] = select(
        "Mixed precision?", ["no", "bf16", "fp16", "fp8"], default="bf16"
    )
    ask("mesh_data", "Data-parallel mesh axis size (-1 = all remaining)", -1, int)
    ask("mesh_fsdp", "FSDP mesh axis size", 1, int)
    ask("mesh_tensor", "Tensor-parallel mesh axis size", 1, int)
    ask("mesh_seq", "Sequence-parallel mesh axis size", 1, int)
    ask("gradient_accumulation_steps", "Gradient accumulation steps", 1, int)
    if config["num_machines"] > 1:
        ask("tpu_hosts", "Comma-separated host list", "")
        ask("main_process_port", "Rendezvous port", 7777, int)
    return config


# legacy key renames, oldest schema first
_LEGACY_KEY_RENAMES = {
    "dp": "mesh_data",
    "fsdp": "mesh_fsdp",
    "tp": "mesh_tensor",
    "sp": "mesh_seq",
    "pp": "mesh_pipe",
    "ep": "mesh_expert",
    "precision": "mixed_precision",
    "hosts": "tpu_hosts",
}


def update_config(path: str) -> dict:
    """Migrate a configuration file written by an older version to the
    current schema: rename legacy keys, drop unknown ones (reported), and
    rewrite the file."""
    # a raw read: load_config() drops unknown keys, the very legacy names this renames
    with open(path) as f:
        config = _load_yaml(f.read())
    migrated = {}
    dropped = []
    legacy_source = {}  # current key -> the legacy spelling that filled it
    for raw_key, value in config.items():
        key = _LEGACY_KEY_RENAMES.get(raw_key, raw_key)
        if key not in CONFIG_KEYS:
            dropped.append(raw_key)
            continue
        if key != raw_key and key in migrated:
            # a stale legacy spelling never clobbers a value under the current name
            dropped.append(raw_key)
            continue
        if key == raw_key and key in legacy_source:
            # the current name wins over an earlier legacy spelling, whatever the file's order
            dropped.append(legacy_source.pop(key))
        try:
            migrated[key] = CONFIG_KEYS[key](value) if value is not None else None
        except (TypeError, ValueError) as e:
            raise ValueError(f"config key {raw_key!r}: cannot cast {value!r} to {CONFIG_KEYS[key].__name__}") from e
        if key != raw_key:
            legacy_source[key] = raw_key
    with open(path, "w") as f:
        f.write(_dump_yaml(migrated))
    if dropped:
        print(f"dropped keys: {', '.join(sorted(dropped))}")
    return migrated


def config_parser(subparsers=None):
    if subparsers is not None:
        parser = subparsers.add_parser("config", help="Create the default launch config")
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch config")
    parser.add_argument("--config_file", default=None)
    parser.add_argument("--default", action="store_true", help="write defaults without prompting")
    parser.add_argument(
        "--update",
        action="store_true",
        help="migrate an existing config file to the current schema instead of creating one",
    )
    if subparsers is not None:
        parser.set_defaults(func=config_command)
    return parser


def config_command(args) -> int:
    if getattr(args, "update", False):
        path = args.config_file or default_config_path()
        if not os.path.isfile(path):
            print(f"no config file at {path}")
            return 1
        try:
            update_config(path)
        except ValueError as e:
            print(f"cannot migrate {path}: {e}")
            return 1
        print(f"Configuration at {path} migrated to the current schema")
        return 0
    if args.default:
        config = {"num_machines": 1, "mixed_precision": "bf16", "mesh_data": -1}
    else:
        config = interactive_config()
    path = save_config(config, args.config_file)
    print(f"Configuration saved to {path}")
    return 0


def main():
    args = config_parser().parse_args()
    raise SystemExit(config_command(args))


if __name__ == "__main__":
    main()
