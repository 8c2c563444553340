"""Config loading, device pick and the test-set reader, a port of
``deephisto_tpu/models/patch_cls_simple/utils.py``.

The machine with the card has no ``yaml``. :func:`load_config`
is the port's one YAML reader, on every machine: the subset the repo's
configs use (nested block maps, ``#`` comments, quoted and plain scalars,
flow lists such as ``multi_mag_layers: [1, 2, 4]``), typed as
``yaml.safe_load`` types it (YAML 1.1: ``0.0001`` is a float, ``True`` and
``yes`` are bools, ``1e-5``, with no dot, is a string). Anything outside the
subset (anchors, aliases, tags, block sequences, block scalars, flow maps,
document markers, timestamps) raises ``ValueError``. :func:`load_image_folder`
reads the JPEG test sets through Pillow, and PNG with the port's own codec
(``_imageio``).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..._device import resolve_device
from ..._imageio import read_png

# yaml.resolver.Resolver's implicit resolvers (YAML 1.1), as safe_load uses them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?)")
_OTHER = re.compile(r"^(?:<<|=)$")
_RESERVED = "&*!|>{%@`"


def _resolve(text: str):
    """A plain scalar typed as ``yaml.safe_load`` types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text) or _INT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if ":" in v:
            raise ValueError(f"sexagesimal number {text!r} is outside the supported YAML")
        if _FLOAT.match(text):
            if v == ".inf":
                return sign * float("inf")
            return float("nan") if v == ".nan" else sign * float(v)
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _TIMESTAMP.match(text) or _OTHER.match(text):
        raise ValueError(f"scalar {text!r} is outside the supported YAML")
    return text


def _quoted(s: str, i: int) -> tuple[str, int]:
    """The quoted scalar starting at ``s[i]``; returns (value, index after it)."""
    q = s[i]
    out, j = [], i + 1
    escapes = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", " ": " "}
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1:j + 2]
            if e not in escapes:
                raise ValueError(f"escape \\{e} is outside the supported YAML")
            out.append(escapes[e])
            j += 2
            continue
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar in {s!r}")


def _strip_comment(s: str) -> str:
    m = re.search(r"(^|\s)#", s)
    return (s[:m.start()] if m else s).strip()


def _check_plain(text: str, line: str) -> str:
    if text and (text[0] in _RESERVED or text.startswith("- ") or text == "-"):
        raise ValueError(f"{line!r}: {text[0]!r} is outside the supported YAML")
    return text


def _flow_list(s: str, i: int) -> tuple[list, int]:
    """The flow list starting at ``s[i] == '['``; returns (list, index after it)."""
    out, j = [], i + 1
    while True:
        while j < len(s) and s[j] == " ":
            j += 1
        if j >= len(s):
            raise ValueError(f"unterminated flow list in {s!r}")
        if s[j] == "]":
            return out, j + 1
        if s[j] == "[":
            item, j = _flow_list(s, j)
        elif s[j] in "'\"":
            item, j = _quoted(s, j)
        else:
            m = re.match(r"[^,\[\]{}#]*", s[j:])
            text = m.group(0).strip()
            if not text or "{" in s[j:j + 1]:
                raise ValueError(f"flow item at {s[j:]!r} is outside the supported YAML")
            item = _resolve(_check_plain(text, s))
            j += m.end()
        out.append(item)
        while j < len(s) and s[j] == " ":
            j += 1
        if j < len(s) and s[j] == ",":
            j += 1
        elif j >= len(s) or s[j] != "]":
            raise ValueError(f"flow list {s!r} is outside the supported YAML")


def _value(rest: str, line: str):
    """The scalar or flow list after ``key:`` on one line."""
    rest = rest.strip()
    if rest[:1] in ("'", '"'):
        v, j = _quoted(rest, 0)
    elif rest[:1] == "[":
        v, j = _flow_list(rest, 0)
    else:
        return _resolve(_check_plain(_strip_comment(rest), line))
    if _strip_comment(rest[j:]):
        raise ValueError(f"{line!r}: text after a quoted scalar or flow list")
    return v


def _key(content: str, line: str):
    """(key, the text after its ':')."""
    if content[0] in ("'", '"'):
        key, j = _quoted(content, 0)
        if content[j:j + 1] != ":":
            raise ValueError(f"{line!r}: a quoted key must be followed by ':'")
        return key, content[j + 1:]
    m = re.search(r":(\s|$)", content)
    if m is None:
        raise ValueError(f"{line!r} is not 'key: value' (outside the supported YAML)")
    key = content[:m.start()].strip()
    return _resolve(_check_plain(key, line)), content[m.start() + 1:]


def parse_yaml(text: str):
    """Parse the supported YAML subset (see the module docstring)."""
    lines = []
    for raw in text.splitlines():
        body = raw.rstrip()
        if not body.strip() or body.strip().startswith("#"):
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent] == "\t":
            raise ValueError(f"{raw!r}: tab indentation is outside the supported YAML")
        if body.startswith(("---", "...", "%")):
            raise ValueError(f"{raw!r}: documents and directives are outside the supported YAML")
        lines.append((indent, body[indent:], raw))
    if not lines:
        return None

    def block(i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(lines) and lines[i][0] >= indent:
            ind, content, raw = lines[i]
            if ind != indent:
                raise ValueError(f"{raw!r}: unexpected indentation")
            key, rest = _key(_check_plain(content, raw), raw)
            i += 1
            if _strip_comment(rest):
                out[key] = _value(rest, raw)
            elif i < len(lines) and lines[i][0] > indent:
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    tree, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"{lines[i][2]!r}: unexpected indentation")
    return tree


def load_config(config_path) -> dict:
    """The YAML config at ``config_path`` (see :func:`parse_yaml`)."""
    return parse_yaml(Path(config_path).read_text())


def get_device():
    """The compute device: the current CUDA device (``resolve_device``)."""
    return resolve_device()


def _read_image(path: Path) -> np.ndarray:
    if path.suffix == ".png":
        return read_png(path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: reading JPEG needs PIL (Pillow), which is not "
                           "installed") from None
    return np.asarray(Image.open(path).convert("RGB"))


def load_image_folder(root: Path | str):
    """Minimal ImageFolder reader: ``root/<class>/*.jpg`` then ``*.png``, class
    folders in name order → (images (N, H, W, 3) uint8, labels (N,) int32,
    class names)."""
    root = Path(root)
    class_dirs = sorted((d for d in root.iterdir() if d.is_dir()), key=lambda d: d.name)
    images, labels = [], []
    for lbl, d in enumerate(class_dirs):
        for f in sorted(d.glob("*.jpg")) + sorted(d.glob("*.png")):
            images.append(_read_image(f))
            labels.append(lbl)
    if not images:
        raise RuntimeError(f"no images under {root}")
    return (
        np.stack(images).astype(np.uint8),
        np.asarray(labels, dtype=np.int32),
        [d.name for d in class_dirs],
    )
