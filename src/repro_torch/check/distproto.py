"""dist-proto: every wire message round-trips through encode/decode.

An unregistered message dataclass in ``dist/proto.py`` encodes fine and
then dies on the *other* side of the socket as "unknown message type" —
in a subprocess, under load, with the traceback buried in a client's
stderr tempfile. This rule makes that a CI failure instead:

* ``MESSAGE_TYPES`` must be a module-level dict **literal** (constant
  string tags → class names) so it can be read statically — computed
  registries hide exactly the drift this rule exists to catch;
* every dataclass defined in ``proto.py`` must be registered exactly
  once, every registered name must be a dataclass defined there, and no
  tag may repeat;
* ``proto.py`` must import only from a stdlib allowlist (no torch, no
  repro_torch internals) — the wire format must be loadable by a bare client
  process before any heavy import succeeds, and it is what lets this
  rule *execute* the module safely;
* each registered message type must actually round-trip: the rule execs
  the module source in an isolated namespace (no package import, works
  in an environment without torch), builds a dummy instance per class from
  its field annotations, and asserts ``decode(encode(msg)) == msg``.
  This catches JSON-hostile field types (tuples come back as lists,
  bytes don't encode) at check time, not mid-benchmark.
"""

from __future__ import annotations

import ast

from repro_torch.check.core import Context, Finding, checker

RULE = "dist-proto"

_PROTO_FILE = "src/repro_torch/dist/proto.py"

# Modules proto.py may import: pure-stdlib, no accelerator stack. The
# exec-based round-trip below is only safe while this holds.
_ALLOWED_IMPORTS = {
    "__future__",
    "dataclasses",
    "json",
    "socket",
    "struct",
    "typing",
}

# Annotation base type -> JSON-stable dummy value. Every value here must
# survive json.dumps/json.loads unchanged, or the round-trip assertion
# would fail for reasons that are this table's fault, not the protocol's.
_DUMMIES = {
    "int": 7,
    "float": 1.25,
    "str": "x",
    "bool": True,
    "dict": {"k": 1},
    "list": [1, 2],
}


def _finding(line: int, message: str) -> Finding:
    return Finding(
        rule=RULE, severity="error", file=_PROTO_FILE, line=line, message=message
    )


def _dataclass_defs(tree: ast.Module) -> dict[str, ast.ClassDef]:
    out: dict[str, ast.ClassDef] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and any(
            "dataclass" in ast.dump(d) for d in node.decorator_list
        ):
            out[node.name] = node
    return out


def _registry_literal(tree: ast.Module) -> tuple[ast.Dict | None, int]:
    """The MESSAGE_TYPES dict literal and its line, or (None, line)."""
    for node in tree.body:
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "MESSAGE_TYPES"
                for t in node.targets
            )
        ):
            if isinstance(node.value, ast.Dict):
                return node.value, node.lineno
            return None, node.lineno
    return None, 1


def _check_imports(tree: ast.Module) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [(node.module or "", node.lineno)]
        for mod, line in mods:
            if mod.split(".")[0] not in _ALLOWED_IMPORTS:
                findings.append(
                    _finding(
                        line,
                        f"proto.py imports {mod!r} — the wire format must "
                        "stay pure-stdlib so bare client processes (and "
                        "this rule's exec) can load it without torch",
                    )
                )
    return findings


def _dummy_instance(cls, errors: list[str]):
    """Build cls with a JSON-stable dummy per field, or record why not."""
    import dataclasses

    kwargs = {}
    for f in dataclasses.fields(cls):
        base = str(f.type).split("|")[0].strip()
        if base not in _DUMMIES:
            errors.append(
                f"{cls.__name__}.{f.name} has annotation {f.type!r} with no "
                "dummy mapping — extend _DUMMIES (and make sure the type is "
                "JSON-stable) when adding new wire field types"
            )
            return None
        kwargs[f.name] = _DUMMIES[base]
    return cls(**kwargs)


def _check_roundtrips(ctx: Context, line: int) -> list[Finding]:
    source = ctx.source(_PROTO_FILE)
    if source is None:
        return []
    import sys
    import types

    # A real (temporary) module entry: the dataclass decorator resolves
    # the defining module through sys.modules, so a bare dict won't do.
    mod = types.ModuleType("_repro_torch_check_distproto_exec")
    sys.modules[mod.__name__] = mod
    try:
        exec(compile(source, _PROTO_FILE, "exec"), mod.__dict__)
    except Exception as e:  # noqa: BLE001 - any load failure is the finding
        return [_finding(line, f"proto.py failed to execute in isolation: {e}")]
    finally:
        sys.modules.pop(mod.__name__, None)
    namespace = mod.__dict__
    registry = namespace.get("MESSAGE_TYPES")
    encode, decode = namespace.get("encode"), namespace.get("decode")
    if not isinstance(registry, dict) or encode is None or decode is None:
        return [
            _finding(line, "proto.py must define MESSAGE_TYPES, encode, decode")
        ]
    findings = []
    header = namespace.get("_HEADER")
    for tag, cls in sorted(registry.items()):
        errors: list[str] = []
        msg = _dummy_instance(cls, errors)
        for err in errors:
            findings.append(_finding(line, err))
        if msg is None:
            continue
        try:
            frame = encode(msg)
            back = decode(frame[header.size :])
        except Exception as e:  # noqa: BLE001
            findings.append(
                _finding(line, f"{tag!r} does not survive encode/decode: {e}")
            )
            continue
        if back != msg:
            findings.append(
                _finding(
                    line,
                    f"{tag!r} round-trip changed the message: sent "
                    f"{msg!r}, got back {back!r} — a field type is not "
                    "JSON-stable (tuples become lists, keys become str)",
                )
            )
    return findings


@checker(
    RULE,
    "every dist/proto.py message dataclass is registered exactly once in "
    "the MESSAGE_TYPES literal and round-trips decode(encode(msg)) == msg",
)
def check_dist_proto(ctx: Context) -> list[Finding]:
    tree = ctx.tree(_PROTO_FILE)
    if tree is None:
        return []
    findings: list[Finding] = []
    findings.extend(_check_imports(tree))

    classes = _dataclass_defs(tree)
    # Exception classes are dataclass-free; anything decorated is a message.
    registry, reg_line = _registry_literal(tree)
    if registry is None:
        findings.append(
            _finding(
                reg_line,
                "MESSAGE_TYPES must be a dict literal of tag -> class so "
                "registration is statically checkable",
            )
        )
        return findings

    tags: list[str] = []
    registered: list[str] = []
    for key, value in zip(registry.keys, registry.values):
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
            findings.append(
                _finding(reg_line, "MESSAGE_TYPES keys must be string literals")
            )
            continue
        tags.append(key.value)
        if not isinstance(value, ast.Name):
            findings.append(
                _finding(
                    reg_line,
                    f"MESSAGE_TYPES[{key.value!r}] must name a class directly",
                )
            )
            continue
        registered.append(value.id)
        if value.id not in classes:
            findings.append(
                _finding(
                    reg_line,
                    f"MESSAGE_TYPES[{key.value!r}] = {value.id} is not a "
                    "dataclass defined in proto.py",
                )
            )

    for tag in sorted({t for t in tags if tags.count(t) > 1}):
        findings.append(
            _finding(reg_line, f"duplicate tag {tag!r} in MESSAGE_TYPES")
        )
    for name in sorted({n for n in registered if registered.count(n) > 1}):
        findings.append(
            _finding(
                reg_line,
                f"{name} registered under more than one tag — one message "
                "type must have one wire identity",
            )
        )
    for name, node in sorted(classes.items()):
        if name not in registered:
            findings.append(
                _finding(
                    node.lineno,
                    f"dataclass {name} is not registered in MESSAGE_TYPES — "
                    "it would encode but never decode on the peer",
                )
            )

    if not findings:
        findings.extend(_check_roundtrips(ctx, reg_line))
    return findings
