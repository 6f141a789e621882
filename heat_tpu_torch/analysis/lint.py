"""AST lint tier of the SPMD hazard analyzer (counterpart of
heat_tpu/analysis/lint.py; ``python -m heat_tpu_torch.analysis``).

Project rules with ``HT0xx`` codes, in their torch forms:

* **HT001**: a raw ``int(os.environ...)`` / ``float(os.environ...)`` parse
  that bypasses :func:`heat_tpu_torch.core.autotune.env_bytes` /
  :func:`heat_tpu_torch.core.envparse.env_int`: a silent fallback turns an
  operator's typo into an invisible performance bug.
* **HT002**: a host sync outside a ``telemetry.timed_call``-wrapped site:
  ``.item()``, ``torch.cuda.synchronize()``, ``.tolist()``/``.cpu()``/
  ``.numpy()`` of a device value, ``float()``/``int()``/``bool()`` of a
  device value.  An unmeasured sync on a hot path stalls the card's queue
  and lands its wait on whatever the roofline times next.
* **HT003**: a data-dependent Python ``if``/``while`` on a device value
  that gates a collective: every rank must reach every collective in the
  same order, and a rank-divergent branch around one deadlocks a mesh of
  processes.
* **HT004**: a module-level counter dict mutated without a registered
  telemetry group: it misses ``snapshot()``/``reset_all()``/
  ``export_prometheus()``.
* **HT005**: ``quantize_weights(w, ..., donate=True)`` followed by a read of
  ``w``: the master's shards were donated (tagged and poisoned for the
  runtime sanitizer).  heat_tpu's ``jax.jit(donate_argnums=...)`` form has
  no torch counterpart.

Suppression: append ``# ht: HT00x ok — <reason>`` to the flagged line.
Residual findings live in ``baseline.json`` next to this file; every entry
must carry a non-empty ``reason`` or ``--check`` refuses it.
``--update-baseline`` rewrites the file from the current scan, keeping the
reasons of findings that persist.
"""

import argparse
import ast
import hashlib
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# ------------------------------------------------------------------ findings

_SUPPRESS_RE = re.compile(r"#\s*ht:\s*(HT\d{3})\s+ok\b")

# namespaces whose call results / attributes are device values
_ARRAY_NS = {"torch", "ht", "heat_tpu_torch"}
# attribute reads that alias the underlying device tensors
_ARRAY_ATTRS = {"larray", "shards"}
# calls a rank-divergent branch must never gate (collective entry points
# and the layout changes that dispatch them); deliberately narrow —
# convergence checks on replicated host scalars around plain math are
# the legitimate SPMD idiom and stay clean
_COLLECTIVES = {
    "resplit", "resplit_", "redistribute_", "all_gather", "all_to_all",
    "psum", "pmax", "pmin", "ppermute", "ring_shift", "bcast", "exscan",
    "reduce_scatter", "psum_scatter", "tiled_resplit", "tiled_gather",
    "tiled_reshape", "tiled_take", "rechunk", "rechunk_rows", "matmul_raw",
    "barrier",
}


class Finding:
    """One lint hit.  ``identity`` is line-drift-stable: the rule code,
    the repo-relative path, a hash of the normalized source line, and an
    occurrence index among same-hash hits in the file."""

    __slots__ = ("code", "path", "line", "col", "message", "identity")

    def __init__(self, code, path, line, col, message, identity):
        self.code = code
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.identity = identity

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"

    def as_dict(self) -> dict:
        return {
            "identity": self.identity, "code": self.code, "path": self.path,
            "line": self.line, "message": self.message,
        }


class _Ctx:
    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self._hash_seen: Dict[str, int] = {}

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, code: str, lineno: int) -> bool:
        m = _SUPPRESS_RE.search(self.line_text(lineno))
        return bool(m and m.group(1) == code)

    def finding(self, code: str, node: ast.AST, message: str) -> Optional[Finding]:
        lineno = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        if self.suppressed(code, lineno):
            return None
        norm = " ".join(self.line_text(lineno).split())
        h = hashlib.md5(f"{code}|{norm}".encode()).hexdigest()[:10]
        n = self._hash_seen.get(h, 0)
        self._hash_seen[h] = n + 1
        identity = f"{code}::{self.relpath}::{h}::{n}"
        return Finding(code, self.relpath, lineno, col, message, identity)


# --------------------------------------------------------------- AST helpers


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for a Name/Attribute chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _mentions_environ(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "environ":
            return True
        if isinstance(sub, ast.Name) and sub.id == "environ":
            return True
    return False


# attribute reads that are host metadata, not device values: coercing
# shape/dtype arithmetic is not a sync
_METADATA_ATTRS = {
    "shape", "gshape", "lshape", "ndim", "dtype", "itemsize", "size",
    "sharding", "split", "ravel_order", "device", "is_cuda", "numel",
    "element_size", "dim", "stride", "nelement", "data_ptr",
    "storage_offset", "is_contiguous", "is_floating_point", "is_complex",
    "requires_grad", "layout", "nnz", "nshards", "comm", "nbytes",
}
# array-namespace calls that return host metadata objects
_METADATA_CALLS = {
    "dtype", "result_type", "promote_types", "issubdtype", "finfo",
    "iinfo", "device_count", "local_device_count", "canonicalize_dtype",
    "device", "Size", "is_available", "get_device_name", "is_tensor",
    "is_floating_point", "is_complex", "can_cast", "get_default_dtype",
    "numel", "canonical_heat_type", "heat_type_of", "get_comm", "MeshComm",
}


def _mentions_array_source(node: ast.AST, tainted: frozenset) -> bool:
    """Does this expression derive from a device *value* — an
    array-namespace call, a ``.larray``/``.parray`` alias, or a tainted
    name?  Metadata reads (``.shape``, ``.itemsize``, ``torch.finfo(...)``)
    are host-side and never trigger."""
    if isinstance(node, ast.Attribute):
        if node.attr in _ARRAY_ATTRS:
            return True
        if node.attr in _METADATA_ATTRS:
            return False  # metadata read of anything is host-side
        return _mentions_array_source(node.value, tainted)
    if isinstance(node, ast.Call):
        dotted = _dotted(node.func)
        root = dotted.split(".", 1)[0]
        leaf = dotted.rsplit(".", 1)[-1]
        if root in _ARRAY_NS:
            return leaf not in _METADATA_CALLS
        return any(
            _mentions_array_source(c, tainted)
            for c in ast.iter_child_nodes(node)
        )
    if isinstance(node, ast.Name):
        return node.id in tainted
    return any(
        _mentions_array_source(c, tainted)
        for c in ast.iter_child_nodes(node)
    )


def _target_names(target: ast.AST) -> List[str]:
    out = []
    for sub in ast.walk(target):
        if isinstance(sub, ast.Name):
            out.append(sub.id)
    return out


def _function_taint(fn: ast.AST) -> Dict[ast.stmt, frozenset]:
    """Per-statement taint snapshot for a function body: which local names
    (at that statement) derive from device values.  Linear, order-of-body
    approximation — loops are walked once, which over-taints slightly and
    never under-taints for the straight-line hazards HT002/HT003 target."""
    tainted: set = set()
    snap: Dict[ast.stmt, frozenset] = {}

    def visit_block(stmts: Sequence[ast.stmt]):
        for st in stmts:
            snap[st] = frozenset(tainted)
            if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = st.value
                targets = (
                    st.targets if isinstance(st, ast.Assign) else [st.target]
                )
                if value is not None and _mentions_array_source(
                    value, frozenset(tainted)
                ):
                    for t in targets:
                        tainted.update(_target_names(t))
                elif isinstance(st, ast.Assign):
                    for t in targets:
                        if isinstance(t, ast.Name):
                            tainted.discard(t.id)
            for block in _child_blocks(st):
                visit_block(block)

    visit_block(getattr(fn, "body", []))
    return snap


def _child_blocks(st: ast.stmt) -> Iterable[Sequence[ast.stmt]]:
    for field in ("body", "orelse", "finalbody"):
        block = getattr(st, field, None)
        if block and isinstance(block, list):
            yield block
    for h in getattr(st, "handlers", []) or []:
        yield h.body


def _functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _inside_timed_call(ancestors: Sequence[ast.AST]) -> bool:
    for anc in ancestors:
        if isinstance(anc, ast.Call):
            name = _dotted(anc.func)
            if name.endswith("timed_call") or name.endswith(".timed"):
                return True
    return False


def _walk_with_ancestors(root: ast.AST):
    stack: List[Tuple[ast.AST, Tuple[ast.AST, ...]]] = [(root, ())]
    while stack:
        node, anc = stack.pop()
        yield node, anc
        child_anc = anc + (node,)
        for child in ast.iter_child_nodes(node):
            stack.append((child, child_anc))


# --------------------------------------------------------------------- rules


def _rule_ht001(tree: ast.Module, ctx: _Ctx) -> List[Finding]:
    """Raw env int/byte parse bypassing env_bytes/env_int."""
    out = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("int", "float")
            and node.args
            and any(_mentions_environ(a) for a in node.args)
        ):
            f = ctx.finding(
                "HT001", node,
                f"raw {node.func.id}(os.environ...) parse — route through "
                "autotune.env_bytes / envparse.env_int so malformed values "
                "raise instead of silently falling back",
            )
            if f:
                out.append(f)
    return out


def _rule_ht002(tree: ast.Module, ctx: _Ctx) -> List[Finding]:
    """Host syncs outside telemetry.timed_call-wrapped sites."""
    out = []
    taint_by_fn = {}
    for fn in _functions(tree):
        taint_by_fn[fn] = _function_taint(fn)

    def nearest_taint(ancestors, node) -> frozenset:
        for anc in reversed(ancestors):
            snap = taint_by_fn.get(anc)
            if snap is not None:
                # the statement snapshot nearest to this expression
                for a in reversed(ancestors):
                    got = snap.get(a)
                    if got is not None:
                        return got
                return frozenset()
        return frozenset()

    for node, ancestors in _walk_with_ancestors(tree):
        if not isinstance(node, ast.Call):
            continue
        hit = None
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "item" and not node.args:
                hit = ".item() host sync"
            elif attr == "synchronize" and _dotted(node.func).endswith("cuda.synchronize"):
                hit = "torch.cuda.synchronize() host sync"
            elif attr in ("tolist", "cpu", "numpy") and not node.args and _mentions_array_source(
                node.func.value, nearest_taint(ancestors, node)
            ):
                hit = f".{attr}() of a device value (host sync)"
        elif (
            isinstance(node.func, ast.Name)
            and node.func.id in ("float", "int", "bool")
            and len(node.args) == 1
            and _mentions_array_source(
                node.args[0], nearest_taint(ancestors, node)
            )
        ):
            hit = f"{node.func.id}() of a device value (host sync)"
        if hit is None:
            continue
        if _inside_timed_call(ancestors):
            continue
        f = ctx.finding(
            "HT002", node,
            f"{hit} outside a telemetry.timed_call-wrapped site — wrap it "
            "or justify with '# ht: HT002 ok — <reason>'",
        )
        if f:
            out.append(f)
    return out


def _rule_ht003(tree: ast.Module, ctx: _Ctx) -> List[Finding]:
    """Data-dependent branch on sharded values gating a collective."""
    out = []
    for fn in _functions(tree):
        snap = _function_taint(fn)
        for node in ast.walk(fn):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            tainted = snap.get(node, frozenset())
            if not _mentions_array_source(node.test, tainted):
                continue
            gated = None
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call):
                    name = _dotted(sub.func).rsplit(".", 1)[-1]
                    if name in _COLLECTIVES:
                        gated = name
                        break
            if gated is None:
                continue
            kw = "while" if isinstance(node, ast.While) else "if"
            f = ctx.finding(
                "HT003", node,
                f"data-dependent `{kw}` on a sharded/device value gates "
                f"collective `{gated}` — a rank-divergent branch here "
                "deadlocks the mesh; hoist the collective or branch on a "
                "replicated host scalar",
            )
            if f:
                out.append(f)
    return out


def _rule_ht004(tree: ast.Module, ctx: _Ctx) -> List[Finding]:
    """Module-level counter dict mutated without a registered group."""
    out = []
    dict_literals: Dict[str, ast.Assign] = {}
    registered: set = set()
    for st in tree.body:
        if isinstance(st, ast.Assign) and len(st.targets) == 1 and isinstance(
            st.targets[0], ast.Name
        ):
            name = st.targets[0].id
            if isinstance(st.value, ast.Dict):
                dict_literals[name] = st
            elif isinstance(st.value, ast.Call) and _dotted(
                st.value.func
            ).endswith("register_group"):
                registered.add(name)
    if not dict_literals:
        return out
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.AugAssign)
            and isinstance(node.target, ast.Subscript)
            and isinstance(node.target.value, ast.Name)
            and node.target.value.id in dict_literals
            and node.target.value.id not in registered
        ):
            name = node.target.value.id
            f = ctx.finding(
                "HT004", node,
                f"counter dict `{name}` mutated without a registered "
                "telemetry group — register it via "
                "telemetry.register_group so snapshot()/reset_all()/"
                "export_prometheus() see it",
            )
            if f:
                out.append(f)
            # one finding per dict keeps the signal readable
            del dict_literals[name]
    return out


def _rule_ht005(tree: ast.Module, ctx: _Ctx) -> List[Finding]:
    """A name donated to ``quantize_weights(..., donate=True)`` and read
    again afterwards."""
    out = []
    for fn in _functions(tree):
        # donated value name -> line of the donating call
        donated: Dict[str, int] = {}
        body_nodes = []
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested scopes analyzed on their own visit
            body_nodes.append(node)
        for node in body_nodes:
            if (
                isinstance(node, ast.Call)
                and _dotted(node.func).endswith("quantize_weights")
                and node.args
                and isinstance(node.args[0], ast.Name)
                and any(
                    kw.arg == "donate" and isinstance(kw.value, ast.Constant) and kw.value.value is True
                    for kw in node.keywords
                )
            ):
                donated.setdefault(node.args[0].id, node.lineno)
        if not donated:
            continue
        rebound: Dict[str, int] = {}
        for node in body_nodes:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    # >= catches the same-line self-rebind `w = f(w)`
                    if isinstance(t, ast.Name) and t.id in donated and node.lineno >= donated[t.id]:
                        rebound.setdefault(t.id, node.lineno)
        flagged = set()
        for node in body_nodes:
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in donated
                and node.id not in flagged
                and node.lineno > donated[node.id]
                and node.lineno < rebound.get(node.id, 1 << 30)
            ):
                flagged.add(node.id)
                f = ctx.finding(
                    "HT005", node,
                    f"`{node.id}` was donated at line {donated[node.id]} (quantize_weights(donate=True)) and is "
                    "read again here: its shards are tagged donated and poisoned",
                )
                if f:
                    out.append(f)
    return out


RULES = {
    "HT001": _rule_ht001,
    "HT002": _rule_ht002,
    "HT003": _rule_ht003,
    "HT004": _rule_ht004,
    "HT005": _rule_ht005,
}


# -------------------------------------------------------------------- engine


def repo_root() -> str:
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..")
    )


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def lint_source(
    source: str, path: str = "<string>", relpath: Optional[str] = None
) -> List[Finding]:
    """Lint one source string; the fixture-level entry the tests use."""
    ctx = _Ctx(path, relpath or path, source)
    try:
        tree = ast.parse(source)
    except SyntaxError as err:
        return [
            Finding(
                "HT000", ctx.relpath, err.lineno or 1, 0,
                f"syntax error: {err.msg}",
                f"HT000::{ctx.relpath}::syntax::0",
            )
        ]
    out = []
    for rule in RULES.values():
        out.extend(rule(tree, ctx))
    out.sort(key=lambda f: (f.path, f.line, f.code))
    return out


def lint_file(path: str, root: Optional[str] = None) -> List[Finding]:
    root = root or repo_root()
    rel = os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path, rel)


def iter_python_files(paths: Sequence[str]) -> List[str]:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [
                d for d in dirnames
                if d not in ("__pycache__", ".git", "node_modules")
            ]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def lint_paths(
    paths: Sequence[str], root: Optional[str] = None
) -> List[Finding]:
    out = []
    for path in iter_python_files(paths):
        out.extend(lint_file(path, root=root))
    return out


# ------------------------------------------------------------------ baseline


def load_baseline(path: Optional[str] = None) -> List[dict]:
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return doc.get("findings", [])


def save_baseline(
    findings: Sequence[Finding], path: Optional[str] = None,
    prev: Optional[List[dict]] = None,
) -> str:
    """Write the baseline from the current scan, carrying forward the
    ``reason`` of entries that persist; fresh entries get a TODO reason
    that ``--check`` will refuse until a human justifies them."""
    path = path or default_baseline_path()
    reasons = {e["identity"]: e.get("reason", "") for e in (prev or [])}
    doc = {
        "comment": (
            "Residual analyzer findings, each with a human justification. "
            "python -m heat_tpu_torch.analysis --update-baseline regenerates; "
            "--check refuses entries without a reason."
        ),
        "findings": [
            dict(f.as_dict(), reason=reasons.get(f.identity, "TODO: justify"))
            for f in findings
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    return path


def check(
    paths: Optional[Sequence[str]] = None,
    baseline_path: Optional[str] = None,
    out=sys.stdout,
) -> int:
    """The ``--check`` gate: scan, subtract justified baseline entries,
    report the rest.  Returns a process exit code."""
    root = repo_root()
    paths = list(paths) if paths else [os.path.join(root, "heat_tpu_torch")]
    findings = lint_paths(paths, root=root)
    baseline = load_baseline(baseline_path)
    by_id = {e["identity"]: e for e in baseline}
    fresh, unjustified = [], []
    for f in findings:
        entry = by_id.pop(f.identity, None)
        if entry is None:
            fresh.append(f)
        elif not str(entry.get("reason", "")).strip() or str(
            entry.get("reason", "")
        ).startswith("TODO"):
            unjustified.append(f)
    for f in fresh:
        print(f.render(), file=out)
    for f in unjustified:
        print(f.render() + "  [baselined without justification]", file=out)
    stale = list(by_id)
    if stale:
        print(
            f"note: {len(stale)} stale baseline entr"
            f"{'y' if len(stale) == 1 else 'ies'} no longer found "
            "(run --update-baseline)", file=out,
        )
    n_bad = len(fresh) + len(unjustified)
    total = len(findings)
    print(
        f"heat_tpu_torch.analysis: {total} finding(s), "
        f"{total - n_bad} baselined+justified, {n_bad} blocking",
        file=out,
    )
    return 1 if n_bad else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.analysis",
        description="SPMD hazard lint (HT001-HT005) over the heat_tpu_torch tree",
    )
    ap.add_argument("paths", nargs="*", help="files/dirs (default: heat_tpu_torch/)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any non-baselined finding (CI gate)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite baseline.json from the current scan, "
                         "keeping existing justifications")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: heat_tpu_torch/analysis/"
                         "baseline.json)")
    args = ap.parse_args(argv)
    if args.update_baseline:
        root = repo_root()
        paths = args.paths or [os.path.join(root, "heat_tpu_torch")]
        findings = lint_paths(paths, root=root)
        prev = load_baseline(args.baseline)
        path = save_baseline(findings, args.baseline, prev=prev)
        print(f"baseline: {len(findings)} finding(s) -> {path}")
        return 0
    return check(args.paths or None, args.baseline)
