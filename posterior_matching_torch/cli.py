"""The training CLIs' shared command line.

Each CLI takes ``--config <name>`` (a configuration of
:data:`posterior_matching_torch.config.CONFIGS`), ``--config.<path> <value>``
or ``--config.<path>=<value>`` flags that set one of its entries, as the
JAX CLIs' ``ml_collections`` config flags do (the value read as a Python
literal, ``True``, ``16``, ``1.5e-4``, ``None``, or else kept as a string; an
entry the configuration lacks is refused), ``--device cpu`` (the GPU
otherwise) and ``--resume_dir <run directory>``, a run of either package
to continue from its ``train_state.pkl`` into a fresh run directory, with
its seed from its ``train_meta.json`` unless ``--config.seed`` is given
(``posterior_matching_tpu/train/resume.py:20-61``); ``train_pm_vdvae`` and
the image eval CLIs also take ``--dist_backend``.
"""
from __future__ import annotations

import argparse
import ast
from typing import Any, Dict, List, Optional, Sequence, Tuple

from posterior_matching_torch.config import CONFIGS
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.train.resume import resolve_seed


def _value(raw: str) -> Any:
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def parse_overrides(args: Sequence[str]) -> List[Tuple[List[str], Any]]:
    """``--config.a.b=v`` / ``--config.a.b v`` flags -> ``(["a", "b"], v)``."""
    out, i = [], 0
    while i < len(args):
        flag = args[i]
        if not flag.startswith("--config."):
            raise ValueError(f"unknown argument {flag!r}")
        key, eq, raw = flag[len("--config."):].partition("=")
        if not eq:
            if i + 1 == len(args):
                raise ValueError(f"{flag} needs a value")
            i += 1
            raw = args[i]
        out.append((key.split("."), _value(raw)))
        i += 1
    return out


def apply_overrides(config: Dict[str, Any], overrides) -> None:
    for path, value in overrides:
        node = config
        for key in path[:-1]:
            node = node.get(key) if isinstance(node, dict) else None
        if not isinstance(node, dict) or path[-1] not in node:
            raise KeyError(f"--config.{'.'.join(path)}: the configuration has no such entry")
        node[path[-1]] = value


def add_dist_backend(parser: argparse.ArgumentParser) -> None:
    """``--dist_backend``, the process group's backend where a launcher
    starts the ranks (``nccl`` on the GPU and ``gloo`` on the CPU unless
    given: :func:`~posterior_matching_torch.parallel.mesh.
    maybe_initialize_distributed`)."""
    parser.add_argument("--dist_backend", default=None, choices=mesh.BACKENDS,
                        help="the ranks' backend: nccl on the GPU, gloo on the CPU unless given")


def parse_config(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]],
                 names: Sequence[str]) -> Tuple[argparse.Namespace, Dict[str, Any]]:
    """Adds ``--config`` (one of ``names``), ``--device`` and
    ``--resume_dir`` to ``parser``, parses ``argv`` and returns the
    arguments and the configuration with its overrides applied and its
    seed resolved (an explicit one, else ``--resume_dir``'s, else a fresh
    draw)."""
    parser.add_argument("--config", required=True, choices=sorted(names))
    parser.add_argument("--device", default=None, help="the GPU unless 'cpu'")
    parser.add_argument("--resume_dir", default=None,
                        help="continue this run directory's train_state.pkl (params, "
                             "optimizer state, EMA params, step) into a fresh run directory")
    args, rest = parser.parse_known_args(argv)
    config = CONFIGS[args.config]()
    try:
        apply_overrides(config, parse_overrides(rest))
    except (ValueError, KeyError) as err:
        parser.error(str(err))
    config["seed"] = resolve_seed(config, args.resume_dir)
    return args, config


def device_resident(config: Dict[str, Any], dataset, device):
    """The training split as the run's ``device_resident_data`` asks: held
    on ``device`` and gathered there (``ArrayDataset.to_device_resident``),
    or as it is."""
    if config.get("device_resident_data", False):
        return dataset.to_device_resident(device)
    return dataset
