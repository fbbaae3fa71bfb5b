"""simcheck lint for the port: AST rules for its fidelity invariants.

The twin of ``repro.analysis.lint`` (stdlib only; importing it never
touches torch)::

    PYTHONPATH=src python -m repro_torch.analysis.lint src tests
    PYTHONPATH=src python -m repro_torch.analysis.lint --rules R002,R005 src

Exit status is nonzero iff any finding survives suppression.  Every finding
prints as ``path:line: RULE message`` so editors and CI logs can jump to it.

Rules (the reference's numbering and semantics):

* **R002** wall-clock (``time.time``/``time.monotonic``/``datetime.now``)
  in simulation-domain modules (any path containing a ``core`` directory).
  Simulation components must read time from ``VirtualClock`` so replays and
  checkpoint restores are bit-deterministic.
* **R003** host syncs inside functions decorated ``@hot_path``: the
  reference's list (``int()``/``float()`` on array expressions,
  ``.item()``, ``np.asarray``/``np.array``, ``jax.device_get``) and
  torch's (``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, ``bool()`` on a tensor expression).  A
  host sync inside the decode loop or round pipeline serializes the launch
  stream.  Shape arithmetic (``.shape``/``.ndim``/``.size``/``len``) is
  exempt; nested ``def``s are not scanned (emission helpers run on
  host-side data by design).
* **R004** ``state_dict``/``load_state_dict`` key symmetry per class: every
  string key written by ``state_dict`` must be consumed on restore, and
  every key the reader hard-requires (plain ``d["k"]`` subscript) must be
  written.  Dynamic consumption (``**kwargs`` splats, ``.items()`` loops)
  or dynamic production (dict comprehensions, ``**`` merges) waives the
  corresponding direction.
* **R005** shared-memory lifecycle: ``SharedMemory(create=True)`` with no
  ``close``/``unlink``/``finalize`` on the enclosing function, class, or
  module scope; and *any* ``resource_tracker.unregister`` call (double
  close beats a leak — see ``runtime/workers._attach_shm``).

The reference's R001 (``jax.jit`` donation without ``keep_unused=True``)
and R006 (a 3-D+ reshape of a reduction operand inside a cohort ``jit``)
are left out of ``RULES``: the port has no ``jax.jit``, no buffer donation
(``recycle_buffers`` writes into retired leaves through ``out=``, which
``sanitizers.poison_recycled`` fences) and no cohort jit; ``fed_reduce``
takes its ``(rows, size)`` operand as it is.

Suppress a finding with a trailing ``# simcheck: ok`` comment (optionally
rule-qualified: ``# simcheck: ok[R003]`` or ``ok[R003,R005]``).
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import pathlib
import sys
from typing import Iterable

__all__ = ["Finding", "lint_file", "lint_source", "lint_paths", "main",
           "RULES"]

RULES = {
    "R002": "wall-clock call in a simulation-domain (VirtualClock) module",
    "R003": "host sync inside a @hot_path function",
    "R004": "state_dict/load_state_dict key asymmetry",
    "R005": "shared-memory segment without a close/unlink/finalize path",
}

# Directories never walked by default: fixture corpora are deliberately bad.
EXCLUDE_DIRS = {"__pycache__", "lint_fixtures", ".git", ".venv",
                "build", "dist", ".eggs"}

_SUPPRESS_TOKEN = "# simcheck: ok"


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# --------------------------------------------------------------------------
# helpers

def _dotted(node: ast.expr) -> str:
    """Best-effort dotted name of a call target ('jax.jit', 'time.time')."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _kw(call: ast.Call, name: str) -> ast.keyword | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


def _is_true(node: ast.expr | None) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _decorator_name(dec: ast.expr) -> str:
    if isinstance(dec, ast.Call):
        dec = dec.func
    return _dotted(dec).rsplit(".", 1)[-1]


def _shape_exempt(node: ast.expr) -> bool:
    """True if the expression is shape/size arithmetic, not array data."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in (
                "shape", "ndim", "size", "itemsize", "nbytes"):
            return True
        if isinstance(sub, ast.Call) and _dotted(sub.func) == "len":
            return True
    return False


def _suppressed(lines: list[str], finding: Finding) -> bool:
    if not 1 <= finding.line <= len(lines):
        return False
    text = lines[finding.line - 1]
    idx = text.find(_SUPPRESS_TOKEN)
    if idx < 0:
        return False
    rest = text[idx + len(_SUPPRESS_TOKEN):].strip()
    if rest.startswith("["):
        rules = rest[1:rest.index("]")] if "]" in rest else rest[1:]
        return finding.rule in {r.strip() for r in rules.split(",")}
    return True  # bare "# simcheck: ok" suppresses every rule on the line


# --------------------------------------------------------------------------
# rule implementations (each: (path, tree, lines) -> iterator of findings)

_WALL_CLOCK = {"time.time", "time.time_ns", "time.monotonic",
               "time.monotonic_ns", "time.perf_counter",
               "time.perf_counter_ns", "datetime.now", "datetime.utcnow",
               "datetime.datetime.now", "datetime.datetime.utcnow",
               "date.today", "datetime.date.today"}


def _simulation_domain(path: str) -> bool:
    return "core" in pathlib.PurePath(path).parts


def _r002_wall_clock(path, tree, lines):
    if not _simulation_domain(path):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _dotted(node.func) in _WALL_CLOCK:
            yield Finding(
                path, node.lineno, "R002",
                f"wall-clock {_dotted(node.func)}() in a simulation-domain "
                "module; inject the VirtualClock instead")


_HOST_ARRAY_FNS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array",
                   "onp.asarray", "onp.array"}
_DEVICE_GET_FNS = {"jax.device_get", "device_get"}
# torch's host syncs: a method that copies a tensor to the host, and a
# blocking wait for the card.
_SYNC_METHODS = {"tolist": ".tolist() copies device data to host",
                 "cpu": ".cpu() copies device data to host",
                 "numpy": ".numpy() materializes device data on host"}
_SYNC_FNS = {"torch.cuda.synchronize", "cuda.synchronize"}


def _hot_path_body(fn: ast.FunctionDef | ast.AsyncFunctionDef):
    """Yield nodes of fn's body without descending into nested defs."""
    stack: list[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _r003_host_syncs(path, tree, lines):
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not any(_decorator_name(d) == "hot_path"
                   for d in fn.decorator_list):
            continue
        for node in _hot_path_body(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            msg = None
            if name in ("int", "float", "bool") and node.args and \
                    not _shape_exempt(node.args[0]):
                msg = f"{name}() on an array expression forces a host sync"
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "item":
                msg = ".item() forces a device->host sync"
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_METHODS:
                msg = _SYNC_METHODS[node.func.attr]
            elif name in _SYNC_FNS:
                msg = f"{name}() blocks the host on the card"
            elif name in _HOST_ARRAY_FNS:
                msg = f"{name}() materializes device data on host"
            elif name in _DEVICE_GET_FNS:
                msg = f"{name}() is a blocking device->host transfer"
            if msg is not None:
                yield Finding(
                    path, node.lineno, "R003",
                    f"in @hot_path {fn.name}(): {msg}")


def _string_keys(fn: ast.AST):
    """(key, line, strict) triples for every dict-key-ish string literal.

    ``strict`` marks hard requirements: plain ``d["k"]`` subscripts.  Keys
    from dict displays, ``.get``/``.pop`` (which carry defaults), and ``"k"
    in d`` tests are collected but tolerated as reader-side extras.
    """
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    yield k.value, k.lineno, False
        elif isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                yield sl.value, node.lineno, isinstance(node.ctx, ast.Load)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("get", "pop", "setdefault") and \
                node.args and isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value, node.lineno, False
        elif isinstance(node, ast.Compare) and \
                isinstance(node.left, ast.Constant) and \
                isinstance(node.left.value, str) and \
                any(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
            yield node.left.value, node.lineno, False


def _dynamic_access(fn: ast.AST) -> bool:
    """True if the function consumes/produces dict keys it never names."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            if any(kw.arg is None for kw in node.keywords):  # Fn(**m)
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "items", "keys", "values", "update"):
                return True
        if isinstance(node, ast.Dict) and any(k is None for k in node.keys):
            return True  # {**base, ...}
        if isinstance(node, (ast.DictComp,)):
            return True
    return False


def _r004_state_dict_symmetry(path, tree, lines):
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        fns = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        writer, reader = fns.get("state_dict"), fns.get("load_state_dict")
        if writer is None or reader is None:
            continue
        written = {}
        for key, line, _ in _string_keys(writer):
            written.setdefault(key, line)
        read, read_strict = {}, {}
        for key, line, strict in _string_keys(reader):
            read.setdefault(key, line)
            if strict:
                read_strict.setdefault(key, line)
        if not _dynamic_access(reader):
            for key, line in sorted(written.items(), key=lambda kv: kv[1]):
                if key not in read:
                    yield Finding(
                        path, line, "R004",
                        f"{cls.name}.state_dict writes {key!r} but "
                        "load_state_dict never consumes it")
        if not _dynamic_access(writer):
            for key, line in sorted(read_strict.items(),
                                    key=lambda kv: kv[1]):
                if key not in written:
                    yield Finding(
                        path, line, "R004",
                        f"{cls.name}.load_state_dict requires {key!r} but "
                        "state_dict never writes it")


def _enclosing_index(tree):
    """Map each node id to its chain of enclosing function/class defs."""
    chains: dict[int, tuple[ast.AST, ...]] = {}

    def visit(node, chain):
        chains[id(node)] = chain
        child_chain = chain
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            child_chain = chain + (node,)
        for child in ast.iter_child_nodes(node):
            visit(child, child_chain)

    visit(tree, ())
    return chains


def _scope_attr_names(scope: ast.AST) -> set[str]:
    names = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Attribute):
            names.add(node.attr)
        elif isinstance(node, ast.Name):
            names.add(node.id)
    return names


_LIFECYCLE_NAMES = {"close", "unlink", "finalize", "cleanup"}


def _r005_shm_lifecycle(path, tree, lines):
    chains = _enclosing_index(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name.endswith("resource_tracker.unregister") or \
                name == "unregister":
            yield Finding(
                path, node.lineno, "R005",
                "resource_tracker.unregister defeats the double-close "
                "doctrine; attach with track=False semantics instead "
                "(see runtime/workers._attach_shm)")
            continue
        if not (name == "SharedMemory" or name.endswith(".SharedMemory")):
            continue
        if not _is_true(getattr(_kw(node, "create"), "value", None)):
            continue
        # Lifecycle may live on the enclosing function, its class (paired
        # acquire/cleanup methods), or the module (caller-managed helpers).
        scopes = list(chains.get(id(node), ())) + [tree]
        if not any(_scope_attr_names(s) & _LIFECYCLE_NAMES for s in scopes):
            yield Finding(
                path, node.lineno, "R005",
                "SharedMemory(create=True) with no close/unlink/finalize "
                "in scope: the segment outlives its creator")


_RULE_FNS = {
    "R002": _r002_wall_clock,
    "R003": _r003_host_syncs,
    "R004": _r004_state_dict_symmetry,
    "R005": _r005_shm_lifecycle,
}


# --------------------------------------------------------------------------
# entry points

def lint_source(source: str, path: str = "<string>",
                rules: Iterable[str] | None = None) -> list[Finding]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 1, "R000",
                        f"syntax error: {exc.msg}")]
    lines = source.splitlines()
    findings: list[Finding] = []
    for rule in (rules or sorted(_RULE_FNS)):
        findings.extend(_RULE_FNS[rule](path, tree, lines))
    findings = [f for f in findings if not _suppressed(lines, f)]
    findings.sort(key=lambda f: (f.line, f.rule))
    return findings


def lint_file(path: str | pathlib.Path,
              rules: Iterable[str] | None = None) -> list[Finding]:
    p = pathlib.Path(path)
    return lint_source(p.read_text(), str(p), rules)


def _walk(paths: Iterable[str | pathlib.Path]):
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_file():
            if p.suffix == ".py":
                yield p
            continue
        for f in sorted(p.rglob("*.py")):
            if not EXCLUDE_DIRS & set(f.parts):
                yield f


def lint_paths(paths: Iterable[str | pathlib.Path],
               rules: Iterable[str] | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for f in _walk(paths):
        findings.extend(lint_file(f, rules))
    return findings


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="simcheck invariant linter for the port (rules "
                    "R002-R005)")
    parser.add_argument("paths", nargs="+",
                        help="files or directories to lint")
    parser.add_argument("--rules", default=None,
                        help="comma-separated subset, e.g. R002,R005")
    args = parser.parse_args(argv)
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in _RULE_FNS]
        if unknown:
            parser.error(f"unknown rules {unknown}; have {sorted(_RULE_FNS)}")
    findings = lint_paths(args.paths, rules)
    for f in findings:
        print(f)
    counts = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    if findings:
        by_rule = ", ".join(f"{r}={n}" for r, n in sorted(counts.items()))
        print(f"simcheck: {len(findings)} finding(s) ({by_rule})")
        return 1
    print("simcheck: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
