"""Hierarchical YAML config, as ``dist_tpu/config/config.py`` builds it.

A run is configured by a YAML file under ``configs/`` that may inherit
from others through ``_BASE`` (one parent) or ``_BASE_RUN`` +
``_BASE_MODEL`` (two parents), merged depth-first child-wins over the
schema ``configs/pool/base.yaml``, then overridden by dotted
``KEY.SUB.KEY value`` pairs that must name existing keys. The result must
equal the JAX package's loader key for key; the tests hold it to that on
every config under ``configs/projects/dist/``.

The port carries its own YAML reader (:mod:`.yaml_lite`) because PyYAML
is not installed where the port runs. The quirky ``"1e-"`` string->float
coercion of the reference is kept: PyYAML reads ``8e-6`` (no dot) as a
string, and :func:`_coerce` turns it into a float at attribute access.
"""

import argparse
import copy
import json
import os

from dist_tpu_torch.config import yaml_lite

_BASE_KEYS = ("_BASE", "_BASE_RUN", "_BASE_MODEL")


def _coerce(value):
    """String->float for '1e-5'-style values (reference
    utils/config.py:246-247)."""
    if isinstance(value, str) and value[1:3] == "e-":
        try:
            return float(value)
        except ValueError:
            return value
    return value


class Config:
    """Attribute-style view over a nested dict of config values
    (``cfg.TRAIN.BATCH_SIZE``)."""

    def __init__(self, cfg_dict=None, level="cfg"):
        object.__setattr__(self, "_level", level)
        object.__setattr__(self, "cfg_dict", cfg_dict or {})
        for k, v in (cfg_dict or {}).items():
            if isinstance(v, dict):
                object.__setattr__(self, k, Config(v, level=f"{level}.{k}"))
            else:
                object.__setattr__(self, k, _coerce(v))

    def __setattr__(self, key, value):
        if key in ("_level", "cfg_dict", "args"):
            object.__setattr__(self, key, value)
            return
        if isinstance(value, dict):
            value = Config(value, level=f"{self._level}.{key}")
        self.cfg_dict[key] = (value.cfg_dict if isinstance(value, Config)
                              else value)
        object.__setattr__(self, key, value)

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __contains__(self, key):
        return key in self.cfg_dict

    def __repr__(self):
        return f"{self.dump()}\n"

    def dump(self):
        return json.dumps(self.cfg_dict, indent=2, default=str)

    def deep_copy(self):
        return Config(copy.deepcopy(self.cfg_dict), level=self._level)

    def to_dict(self):
        return copy.deepcopy(self.cfg_dict)


def _deep_merge(base, new, preserve_base=False):
    """Child-wins deep merge; ``preserve_base`` keeps a ``_BASE_RUN``
    parent's own ``_BASE*`` keys so a ``_BASE_MODEL`` merge can follow."""
    for k, v in new.items():
        if k in base:
            if isinstance(v, dict) and isinstance(base[k], dict):
                _deep_merge(base[k], v)
            else:
                base[k] = v
        elif k not in _BASE_KEYS or preserve_base:
            base[k] = v
    return base


def _resolve(path, current_file):
    """A base-file reference, relative to the including file."""
    if os.path.isabs(path):
        return path
    here = os.path.dirname(os.path.abspath(current_file))
    if path.startswith("./"):
        path = path[2:]
    return os.path.normpath(os.path.join(here, path))


def load_yaml(path):
    with open(path, "r") as f:
        return yaml_lite.safe_load(f.read())


def _load_yaml_tree(path):
    """One YAML file with its ``_BASE*`` parents folded in."""
    cfg = load_yaml(path) or {}
    if not any(k in cfg for k in _BASE_KEYS):
        return cfg
    if "_BASE" in cfg:
        return _deep_merge(_load_yaml_tree(_resolve(cfg["_BASE"], path)), cfg)
    if "_BASE_RUN" in cfg:
        base = _load_yaml_tree(_resolve(cfg["_BASE_RUN"], path))
        cfg = _deep_merge(base, cfg, preserve_base=True)
    if "_BASE_MODEL" in cfg:
        base = _load_yaml_tree(_resolve(cfg["_BASE_MODEL"], path))
        cfg = _deep_merge(base, cfg)
    return cfg


def _find_base_schema(cfg_file):
    """configs/pool/base.yaml in the cwd or in a directory above the
    config file."""
    candidates = ["./configs/pool/base.yaml"]
    d = os.path.dirname(os.path.abspath(cfg_file))
    for _ in range(6):
        candidates.append(os.path.join(d, "configs", "pool", "base.yaml"))
        d = os.path.dirname(d)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        "configs/pool/base.yaml not found (looked in cwd and above the cfg file)"
    )


def _parse_opt_value(raw, old_value):
    """A CLI override value, typed as YAML; an int given for a float key
    becomes a float."""
    try:
        val = yaml_lite.safe_load(raw)
    except (ValueError, IndexError):
        val = raw
    if isinstance(old_value, float) and isinstance(val, int):
        val = float(val)
    return val


def merge_opts(cfg_dict, opts):
    """Apply ``KEY.SUB.KEY value`` overrides (depth <= 4, keys must
    exist)."""
    if len(opts) % 2:
        raise ValueError(f"Override list {opts} has odd length: {len(opts)}.")
    for key, raw in zip(opts[0::2], opts[1::2]):
        parts = key.split(".")
        if len(parts) > 4:
            raise ValueError(f"Key depth error. Maximum depth: 4. Got: {key}")
        node = cfg_dict
        for p in parts:
            if not isinstance(node, dict) or p not in node:
                raise KeyError(f"Non-existent key: {key}.")
            parent, node = node, node[p]
        parent[parts[-1]] = _parse_opt_value(raw, node)
    return cfg_dict


def load_config(cfg_file, opts=(), init_method=None, make_output_dir=True):
    """Base schema -> YAML hierarchy -> CLI overrides, as a Config."""
    schema = _load_yaml_tree(_find_base_schema(cfg_file))
    cfg_dict = _deep_merge(schema, _load_yaml_tree(cfg_file))
    cfg_dict = merge_opts(cfg_dict, list(opts))
    cfg = Config(cfg_dict)
    cfg.args = argparse.Namespace(
        cfg_file=cfg_file, init_method=init_method, opts=list(opts))
    if make_output_dir and cfg.get("OUTPUT_DIR"):
        os.makedirs(os.path.join(cfg.OUTPUT_DIR, "checkpoints"), exist_ok=True)
    return cfg


def parse_args(argv=None):
    """The CLI contract of ``runs/run.py``: ``--cfg`` + ``--init_method``
    + KEY VALUE overrides; the port adds ``--device`` (default: the CUDA
    card; ``cpu`` runs on the CPU)."""
    parser = argparse.ArgumentParser(description="dist_tpu_torch config")
    parser.add_argument("--cfg", dest="cfg_file", default=None,
                        help="Path to the configuration file")
    parser.add_argument("--init_method", default=None, type=str,
                        help="where the ranks of a data-parallel launch "
                             "meet (tcp://host:port or file://path); "
                             "default: MASTER_ADDR/MASTER_PORT, else a "
                             "file in a fresh temporary directory")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device to run on (default: the CUDA "
                             "card; raises without one)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def load_from_args(argv=None):
    """The Config of a command line; ``cfg.args`` holds ``cfg_file``,
    ``init_method``, ``opts`` and ``device``."""
    args = parse_args(argv)
    if args.cfg_file is None:
        raise ValueError("--cfg is required")
    cfg = load_config(args.cfg_file, args.opts or [], args.init_method)
    cfg.args.device = args.device
    return cfg
