"""Config system of the training harness (≙ xhy_flash_attention_tpu
training/config.py): a YAML tree with ``defaults:`` composition, ``${...}``
interpolation, two resolvers (``eval``, ``div_up``) and dotted-key
overrides, into plain dataclasses.

The port does not depend on PyYAML: :func:`parse_yaml` reads the subset of
YAML that the repository's config files use (block and flow mappings, flow
lists, comments, numbers, booleans, null and plain or quoted strings),
resolving scalars as PyYAML's ``safe_load`` does.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["DataConfig", "OptimizerConfig", "SchedulerConfig", "TrainConfig",
           "load_config", "model_dtype", "parse_yaml", "resolve"]


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 6e-4
    weight_decay: float = 0.1
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    grad_clip: float = 1.0


@dataclasses.dataclass
class SchedulerConfig:
    name: str = "cosine_warmup"  # cosine_warmup | linear_warmup | constant
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class DataConfig:
    path: str = ""
    seqlen: int = 1024
    batch_size: int = 8
    seed: int = 0
    dtype: str = "uint16"


@dataclasses.dataclass
class TrainConfig:
    # "lm" -> Trainer; "image" (the ViT trainer) is not ported yet
    task: str = "lm"
    model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    max_steps: int = 1000
    log_every: int = 10
    ckpt_every: int = 500
    ckpt_dir: str = "checkpoints"
    resume: bool = True
    seed: int = 0
    dtype: str = "bfloat16"
    # mesh axes (dp, tp); (1, 1) = one device, the only layout ported yet
    mesh: Tuple[int, int] = (1, 1)
    sequence_parallel: bool = False
    zero_stage: int = 1
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 0


# ---- the YAML subset --------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), decimal forms
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")


def _scalar(text: str) -> Any:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else \
            body.encode().decode("unicode_escape")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at the line start or after a space) outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow(text: str, pos: int = 0):
    """Parse one flow node (mapping, list or scalar) from ``text`` at
    ``pos``; return (value, position after it)."""
    n = len(text)

    def skip(p):
        while p < n and text[p] in " \t":
            p += 1
        return p

    pos = skip(pos)
    if pos < n and text[pos] in "[{":
        close = "]" if text[pos] == "[" else "}"
        items: Any = [] if close == "]" else {}
        pos = skip(pos + 1)
        if pos < n and text[pos] == close:
            return items, pos + 1
        while True:
            if close == "]":
                value, pos = _flow(text, pos)
                items.append(value)
            else:
                key, pos = _flow_scalar(text, pos, ":")
                pos = skip(pos)
                if pos >= n or text[pos] != ":":
                    raise ValueError(f"expected ':' in flow mapping {text!r}")
                value, pos = _flow(text, pos + 1)
                items[_scalar(key)] = value
            pos = skip(pos)
            if pos < n and text[pos] == ",":
                pos = skip(pos + 1)
                if pos < n and text[pos] == close:  # trailing comma
                    return items, pos + 1
                continue
            if pos < n and text[pos] == close:
                return items, pos + 1
            raise ValueError(f"unterminated flow collection {text!r}")
    raw, pos = _flow_scalar(text, pos, ",]}")
    return _scalar(raw), pos


def _flow_scalar(text: str, pos: int, stops: str):
    """A plain or quoted scalar up to one of ``stops`` (a ':' stop needs a
    space or an end after it)."""
    if pos < len(text) and text[pos] in "'\"":
        quote = text[pos]
        end = text.index(quote, pos + 1)
        return text[pos:end + 1], end + 1
    i = pos
    while i < len(text):
        ch = text[i]
        if ch in stops and (ch != ":" or i + 1 == len(text)
                            or text[i + 1] in " \t,]}"):
            break
        i += 1
    return text[pos:i].strip(), i


def _key_value(content: str):
    """Split ``key: rest`` of a block mapping line."""
    key, pos = _flow_scalar(content, 0, ":")
    if pos >= len(content) or content[pos] != ":":
        raise ValueError(f"expected 'key: value', got {content!r}")
    return _scalar(key), content[pos + 1:].strip()


def _inline(rest: str) -> Any:
    """The value written on a block line: a flow collection or a plain or
    quoted scalar (which, outside a flow collection, may hold ']' or '}')."""
    return _flow(rest)[0] if rest[0] in "[{" else _scalar(rest)


def _block(lines: List[Tuple[int, str]], i: int, indent: int):
    """Parse the block mapping whose lines start at ``lines[i]`` with
    indentation ``indent``; ``lines`` holds (indentation, stripped text)
    pairs. Returns (mapping, next line index)."""
    if lines[i][1].startswith("-"):
        raise ValueError("block lists are not in the repository's configs: "
                         f"write {lines[i][1]!r} as a flow list [...]")
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        key, rest = _key_value(lines[i][1])
        i += 1
        if rest:
            out[key] = _inline(rest)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str) -> Any:
    """The repository's YAML subset -> Python values (None for an empty
    document)."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip() and line.strip() != "---":
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    if len(lines) == 1 and lines[0][1][0] in "[{":
        return _flow(lines[0][1])[0]
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return value


# ---- interpolation and loading ---------------------------------------------

_RESOLVERS = {
    "eval": lambda expr: eval(expr, {"math": math}),  # noqa: S307 (≙ Hydra eval resolver)
    "div_up": lambda a, b: (int(a) + int(b) - 1) // int(b),
}


def resolve(tree: Any, root: Optional[dict] = None) -> Any:
    """Resolve ${path.to.key} interpolations and ${resolver:args} calls
    (≙ OmegaConf interpolation + the reference's custom resolvers)."""
    if root is None:
        root = tree

    def lookup(path: str):
        node = root
        for part in path.split("."):
            node = node[part]
        return node

    inner_re = re.compile(r"\$\{([^${}]+)\}")

    def eval_expr(expr: str):
        if ":" in expr:
            name, arg = expr.split(":", 1)
            return _RESOLVERS[name](*[a.strip() for a in arg.split(",")])
        return resolve(lookup(expr), root)

    def resolve_str(s: str):
        # innermost-first so nested ${...:${...}} compose
        while True:
            m = inner_re.fullmatch(s)
            if m:
                return eval_expr(m.group(1))
            m = inner_re.search(s)
            if not m:
                return s
            s = s[:m.start()] + str(eval_expr(m.group(1))) + s[m.end():]

    if isinstance(tree, dict):
        return {k: resolve(v, root) for k, v in tree.items()}
    if isinstance(tree, list):
        return [resolve(v, root) for v in tree]
    if isinstance(tree, str):
        return resolve_str(tree)
    return tree


def load_config(path: str | Path, overrides: Optional[Dict[str, Any]] = None
                ) -> TrainConfig:
    """Load a YAML config with `defaults:` composition, interpolation, and
    dotted-key overrides (≙ Hydra CLI overrides)."""
    path = Path(path)

    def load_tree(p: Path) -> dict:
        tree = parse_yaml(p.read_text()) or {}
        base: dict = {}
        for default in tree.pop("defaults", []):
            if isinstance(default, dict):
                (group, name), = default.items()
                sub = load_tree(p.parent / group / f"{name}.yaml")
                base[group] = _merge(base.get(group, {}), sub)
            else:
                base = _merge(base, load_tree(p.parent / f"{default}.yaml"))
        return _merge(base, tree)

    tree = load_tree(path)
    for key, val in (overrides or {}).items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    tree = resolve(tree)

    return TrainConfig(
        model=tree.get("model", {}),
        optimizer=OptimizerConfig(**tree.get("optimizer", {})),
        scheduler=SchedulerConfig(**tree.get("scheduler", {})),
        data=DataConfig(**tree.get("data", {})),
        **{k: v for k, v in tree.items()
           if k in {"task", "max_steps", "log_every", "ckpt_every",
                    "ckpt_dir", "resume", "seed", "dtype",
                    "sequence_parallel", "zero_stage", "pipeline_parallel",
                    "pipeline_microbatches"}},
        mesh=tuple(tree.get("mesh", (1, 1))),
    )


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def model_dtype(cfg: TrainConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
