"""Minimal first-party xacro processor (host only).

Copy of grasptrajopt_tpu/models/xacro.py. Robot descriptions written in
xacro (the kuka_lbr's) are expanded to a URDF string before parsing; the
ROS `xacro` package is not a dependency, so this module implements the
subset of the language those descriptions use:

  - ``<xacro:property name=... value=...>`` definitions
  - ``<xacro:include filename=...>`` (relative paths, properties/macros
    merge into the current scope, document elements splice in place)
  - ``<xacro:macro name=... params="a b:=default c:=^|default">`` with the
    caller-scope-inheritance ``^`` / ``^|default`` param syntax
  - macro instantiation ``<xacro:NAME attr=.../>``
  - ``${expr}`` substitution in attributes and text: python expressions
    over the property/param scope plus ``pi`` and the ``math`` namespace
  - ``<xacro:if value=...>`` / ``<xacro:unless value=...>``

The output URDF string feeds the regular parser (models/urdf.py).
"""

from __future__ import annotations

import math
import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

XACRO_NS = "http://www.ros.org/wiki/xacro"

_SUBST_RE = re.compile(r"\$\{([^}]*)\}")


class XacroError(ValueError):
    pass


def _local_tag(elem: ET.Element) -> Optional[str]:
    """The xacro directive name of an element, or None for plain XML."""
    tag = elem.tag
    if isinstance(tag, str) and tag.startswith("{" + XACRO_NS + "}"):
        return tag.split("}", 1)[1]
    return None


class _Scope:
    """Chained property/macro scope (macro call frames chain to global)."""

    def __init__(self, parent: Optional["_Scope"] = None):
        self.parent = parent
        self.props: Dict[str, object] = {}
        self.macros: Dict[str, ET.Element] = {} if parent is None else parent.macros

    def lookup(self, name: str):
        scope: Optional[_Scope] = self
        while scope is not None:
            if name in scope.props:
                return scope.props[name]
            scope = scope.parent
        raise KeyError(name)

    def flat(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        chain: List[_Scope] = []
        scope: Optional[_Scope] = self
        while scope is not None:
            chain.append(scope)
            scope = scope.parent
        for scope in reversed(chain):
            out.update(scope.props)
        return out


def _coerce(text: str):
    """xacro values act as numbers inside ${} when they parse as one."""
    try:
        return int(text)
    except (TypeError, ValueError):
        pass
    try:
        return float(text)
    except (TypeError, ValueError):
        return text


_EVAL_GLOBALS = {
    "__builtins__": {},
    "pi": math.pi,
    "math": math,
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "sqrt": math.sqrt,
    "radians": math.radians,
    "degrees": math.degrees,
    "abs": abs,
    "min": min,
    "max": max,
}


def _eval_expr(expr: str, scope: _Scope):
    env = dict(_EVAL_GLOBALS)
    for k, v in scope.flat().items():
        env[k] = v
    try:
        return eval(expr, env)  # noqa: S307 - restricted globals, local files
    except Exception as e:  # pragma: no cover - error path
        raise XacroError(f"cannot evaluate xacro expression '${{{expr}}}': {e}") from e


def _fmt(value) -> str:
    if isinstance(value, float):
        return repr(value)
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


def _substitute(text: str, scope: _Scope) -> str:
    if "${" not in text:
        return text
    return _SUBST_RE.sub(lambda m: _fmt(_eval_expr(m.group(1), scope)), text)


def _truthy(text: str) -> bool:
    t = text.strip().lower()
    if t in ("true", "1"):
        return True
    if t in ("false", "0", ""):
        return False
    try:
        return float(t) != 0.0
    except ValueError:
        raise XacroError(f"cannot interpret '{text}' as a condition")


def _parse_params(spec: str) -> List[tuple]:
    """Parse a macro params attribute into (name, mode, default) tuples.

    mode: 'required' | 'default' | 'inherit' (``^``) |
    'inherit_or_default' (``^|default``).
    """
    out = []
    for token in spec.split():
        if ":=" not in token:
            out.append((token, "required", None))
            continue
        name, default = token.split(":=", 1)
        if default == "^":
            out.append((name, "inherit", None))
        elif default.startswith("^|"):
            out.append((name, "inherit_or_default", default[2:]))
        else:
            out.append((name, "default", default))
    return out


def _expand_into(out_parent: ET.Element, elem: ET.Element, scope: _Scope, base_dir: str) -> None:
    """Process one source element, appending expansion results to out_parent."""
    directive = _local_tag(elem)

    if directive == "property":
        name = elem.get("name")
        scope.props[name] = _coerce(_substitute(elem.get("value", ""), scope))
        return

    if directive == "macro":
        scope.macros[elem.get("name")] = elem
        return

    if directive == "include":
        path = _substitute(elem.get("filename", ""), scope)
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        inc_root = ET.parse(path).getroot()
        for child in inc_root:
            _expand_into(out_parent, child, scope, os.path.dirname(path))
        return

    if directive in ("if", "unless"):
        cond = _truthy(_substitute(elem.get("value", ""), scope))
        if (directive == "if") == cond:
            for child in elem:
                _expand_into(out_parent, child, scope, base_dir)
        return

    if directive is not None:
        # macro instantiation: <xacro:NAME a="..." b="..."/>
        macro = scope.macros.get(directive)
        if macro is None:
            raise XacroError(f"unknown xacro directive or macro '{directive}'")
        frame = _Scope(parent=scope)
        given = {k: _coerce(_substitute(v, scope)) for k, v in elem.attrib.items()}
        for name, mode, default in _parse_params(macro.get("params", "")):
            if name in given:
                frame.props[name] = given[name]
            elif mode in ("inherit", "inherit_or_default"):
                try:
                    frame.props[name] = scope.lookup(name)
                except KeyError:
                    if mode == "inherit":
                        raise XacroError(f"macro '{directive}' param '{name}' not inheritable")
                    frame.props[name] = _coerce(default)
            elif mode == "default":
                frame.props[name] = _coerce(default)
            else:
                raise XacroError(f"macro '{directive}' missing required param '{name}'")
        for child in macro:
            _expand_into(out_parent, child, frame, base_dir)
        return

    # plain XML: substitute attributes/text, recurse into children
    new = ET.SubElement(
        out_parent, elem.tag, {k: _substitute(v, scope) for k, v in elem.attrib.items()}
    )
    if elem.text and elem.text.strip():
        new.text = _substitute(elem.text, scope)
    for child in elem:
        _expand_into(new, child, scope, base_dir)


def process_xacro_string(text: str, base_dir: str = ".") -> str:
    """Expand a xacro document to a plain URDF XML string."""
    src_root = ET.fromstring(text)
    scope = _Scope()
    out_root = ET.Element(
        src_root.tag, {k: v for k, v in src_root.attrib.items() if "xacro" not in k}
    )
    for child in src_root:
        _expand_into(out_root, child, scope, base_dir)
    return ET.tostring(out_root, encoding="unicode")


def process_xacro_file(path: str) -> str:
    with open(path) as f:
        text = f.read()
    return process_xacro_string(text, base_dir=os.path.dirname(os.path.abspath(path)))
