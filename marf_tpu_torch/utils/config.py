"""Options for the port: the reference's CLI DSL and yaml files (reference
options.py), with torch-native device and seed handling.

    --key1.key2=value   -> yaml-parsed value
    --key1.key2=        -> None
    --key1.key2         -> True
    --key1.key2!        -> False

Yaml base files inherit through `_parent_`; CLI overrides merge on top with
an unknown-key guard that auto-accepts in non-interactive runs (MARF_YES=1 or
no tty). The yaml files are the port's own copy of marf_tpu's planar.yaml
family, in marf_tpu_torch/configs (tests/test_torch_trainer.py holds each
byte-equal to its marf_tpu/configs original). `--cpu` selects the CPU;
otherwise the device is CUDA, and without a card `resolve_device` raises
instead of carrying on on the CPU. PyYAML is imported where a file or value
is parsed.
"""

from __future__ import annotations

import os
import random
import string
import sys

import numpy as np
import torch

from marf_tpu_torch.utils.attrdict import AttrDict, to_plain_dict
from marf_tpu_torch.utils.console import log

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def _interactive(interactive) -> bool:
    if interactive is None:
        return os.environ.get("MARF_YES", "") not in ("1", "true") and sys.stdin.isatty()
    return interactive


def _confirm(question: str) -> None:
    answer = None
    while answer not in ("y", "n"):
        answer = input(f"{question} (y/n) ")
    if answer == "n":
        print("safe exiting...")
        sys.exit(0)


def resolve_yaml_path(name_or_path: str) -> str:
    """`--yaml=` value -> file: as given, options/<name>.yaml, or the
    planar.yaml family in marf_tpu_torch/configs."""
    candidates = [name_or_path, f"options/{name_or_path}.yaml", os.path.join(_CONFIG_DIR, f"{name_or_path}.yaml")]
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"config yaml not found; tried {candidates}")


def resolve_device(cpu: bool = False) -> torch.device:
    """`--cpu` -> the CPU. Otherwise CUDA device 0, with TF32 off for float32
    matmuls and cuDNN convolutions (the port's numbers are float32); raises
    when no card is visible."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def parse_arguments(args: list[str]) -> AttrDict:
    """CLI tokens (`--a.b=value`, `--flag`, `--flag!`) -> nested overrides
    for `set_opt` (reference options.py:14-39)."""
    import yaml

    opt_cmd = {}
    for arg in args:
        if not arg.startswith("--"):
            raise ValueError(f"argument must start with '--': {arg}")
        if "=" not in arg[2:]:
            key_str, value = (arg[2:-1], "false") if arg[-1] == "!" else (arg[2:], "true")
        else:
            key_str, value = arg[2:].split("=", 1)
        *parents, leaf = key_str.split(".")
        sub = opt_cmd
        for k in parents:
            sub = sub.setdefault(k, {})
        if leaf in sub:
            raise ValueError(f"duplicate key: {key_str}")
        sub[leaf] = yaml.safe_load(value)
    return AttrDict(opt_cmd)


def load_options(fname: str) -> AttrDict:
    """A yaml options file with its `_parent_` bases merged underneath
    (reference options.py:59-73). A parent path is tried relative to the
    child's directory, then as given, then in marf_tpu_torch/configs."""
    import yaml

    with open(fname, encoding="utf-8") as file:
        opt = AttrDict(yaml.safe_load(file) or {})
    parents = opt.pop("_parent_", [])
    for parent in [parents] if isinstance(parents, str) else parents:
        for cand in (
            os.path.join(os.path.dirname(os.path.abspath(fname)), parent),
            parent,
            os.path.join(_CONFIG_DIR, os.path.basename(parent)),
        ):
            if os.path.isfile(cand):
                parent = cand
                break
        opt = override_options(load_options(parent), opt)
    return opt


def override_options(opt, opt_over, key_stack=None, safe_check=False, interactive=None):
    """Merge `opt_over` into `opt` (reference options.py:76-96). With
    `safe_check`, a key `opt` lacks asks for confirmation, or is accepted
    with a warning in a non-interactive run."""
    key_stack = key_stack or []
    interactive = _interactive(interactive)
    for key, value in opt_over.items():
        if isinstance(value, dict):
            opt[key] = override_options(opt.get(key, AttrDict()), value, key_stack + [key], safe_check, interactive)
            continue
        if safe_check and key not in opt:
            key_str = ".".join(key_stack + [key])
            if interactive:
                _confirm(f'"{key_str}" not found in original opt, add?')
            else:
                log.warn(f'adding new config key "{key_str}" (non-interactive auto-accept)')
        opt[key] = value
    return opt


def set_opt(opt_cmd=None, interactive=None) -> AttrDict:
    """Final options from CLI overrides on top of the `--yaml` base file
    (reference options.py:42-56)."""
    opt_cmd = AttrDict() if opt_cmd is None else opt_cmd
    log.info("setting configurations...")
    if "model" not in opt_cmd or "yaml" not in opt_cmd:
        raise ValueError("--model and --yaml must be specified")
    opt = load_options(resolve_yaml_path(str(opt_cmd.yaml)))
    opt = override_options(opt, opt_cmd, key_stack=[], safe_check=True, interactive=interactive)
    process_options(opt)
    log.options(opt)
    return opt


def seed_rngs(seed: int) -> None:
    """Seed Python's, numpy's and torch's global RNGs."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def process_options(opt: AttrDict) -> None:
    """Seed the RNGs, derive the run name and output path (reference
    options.py:99-120) and resolve `opt.device`."""
    if opt.get("seed") is not None:
        seed_rngs(opt.seed)
        if opt.seed != 0:
            opt.name = f"{opt.name}_seed{opt.seed}"
    else:
        opt.name = f"{opt.name}_{''.join(random.choice(string.ascii_uppercase) for _ in range(4))}"
    opt.output_path = f"{opt.output_root}/{opt.group}/{opt.name}"
    os.makedirs(opt.output_path, exist_ok=True)
    opt.device = str(resolve_device(bool(opt.get("cpu"))))


def save_options_file(opt: AttrDict, interactive=None) -> None:
    """Write the options to `<output_path>/options.yaml`; an existing,
    different snapshot is diffed and overridden after confirmation, or with a
    warning in a non-interactive run (reference options.py:123-150)."""
    import yaml

    fname = f"{opt.output_path}/options.yaml"
    plain = to_plain_dict(opt)
    if os.path.isfile(fname):
        with open(fname, encoding="utf-8") as file:
            old = yaml.safe_load(file)
        if plain != old:
            print("existing options file found (different from current one)...")
            _print_options_diff(old, plain)
            if _interactive(interactive):
                _confirm("override?")
            else:
                log.warn("overriding existing options file (non-interactive)")
        else:
            print("existing options file found (identical)")
    else:
        print("(creating new options file...)")
    with open(fname, "w", encoding="utf-8") as file:
        yaml.safe_dump(plain, file, default_flow_style=False, indent=4)


def _print_options_diff(old, new, prefix=""):
    for key in sorted(set(old or {}) | set(new or {})):
        vo, vn = (old or {}).get(key, "<absent>"), (new or {}).get(key, "<absent>")
        if isinstance(vo, dict) or isinstance(vn, dict):
            _print_options_diff(vo if isinstance(vo, dict) else {}, vn if isinstance(vn, dict) else {}, f"{prefix}{key}.")
        elif vo != vn:
            print(f"  {prefix}{key}: {vo} -> {vn}")
