"""The port's copies of reference modules against the reference files.

A verbatim copy must equal the reference byte for byte once the package name
is renamed (`karpenter_tpu` -> `karpenter_tpu_torch`). A copy with CUDA
replacements may differ only inside its port-specific parts, listed here by
name: module-level functions, classes, methods (`Class.method`), a class's
docstring (`Class.__doc__`), the module docstring (`__doc__`), assignments
(with the comment block above them), and import lines the port adds. Every
other line must be the reference's. One case per module.
"""

from __future__ import annotations

import ast
import difflib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VERBATIM = [
    "aot/__init__.py",
    "aot/ladder.py",
    "aot/cache.py",
    "aot/runtime.py",
    "observability/slo.py",
    "observability/flight.py",
    "ops/topo_counts.py",
    "tracing/journey.py",
]

# module -> the port-specific parts (see the module docstring), and the
# replacements of lines inside a shared function: (reference lines, port
# lines), each matched exactly
PORT_SPECIFIC = {
    "observability/kernels.py": (["sample_device_memory"], []),
    "tracing/kernel.py": (
        ["__doc__", "_cache_size", "_cuda_devices", "_fence"],
        [(
            [
                "            try:",
                "                import jax",
                "",
                "                jax.block_until_ready(out)",
                "            except Exception:  # noqa: BLE001 — host twins return plain numpy",
                "                pass",
            ],
            ["            _fence(out)"],
        )],
    ),
    "observability/efficiency.py": (
        ["__doc__", "DEVICE_PEAKS", "_device_peaks", "DeviceProfiler.__doc__",
         "DeviceProfiler.available", "DeviceProfiler.activities", "DeviceProfiler._run"],
        [],
    ),
}


def _renamed_reference(rel: str) -> str:
    with open(os.path.join(REPO, "karpenter_tpu", rel)) as f:
        return re.sub(r"\bkarpenter_tpu\b", "karpenter_tpu_torch", f.read())


def _port(rel: str) -> str:
    with open(os.path.join(REPO, "karpenter_tpu_torch", rel)) as f:
        return f.read()


def _spans(source: str, names) -> set[int]:
    """0-based line numbers of the named parts of `source` (a part absent
    from this file contributes nothing)."""
    tree = ast.parse(source)
    lines = source.splitlines()
    out: set[int] = set()

    def add(node, with_comments=True):
        first = min([node.lineno] + [d.lineno for d in getattr(node, "decorator_list", [])]) - 1
        if with_comments:
            while first > 0 and lines[first - 1].lstrip().startswith("#"):
                first -= 1
        out.update(range(first, node.end_lineno))

    def find(body, name):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and node.name == name:
                return node
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets
            ):
                return node
        return None

    for name in names:
        parts = name.split(".")
        if parts == ["__doc__"]:
            add(tree.body[0], with_comments=False)
            continue
        body = tree.body
        node = None
        for part in parts:
            if part == "__doc__":
                node = body[0]
                break
            node = find(body, part)
            if node is None:
                break
            body = getattr(node, "body", [])
        if node is not None:
            add(node, with_comments=parts[-1] != "__doc__")
    return out


def _is_import_or_blank(line: str) -> bool:
    s = line.strip()
    return not s or s.startswith(("import ", "from "))


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_is_byte_identical(rel):
    assert _port(rel) == _renamed_reference(rel), f"{rel} differs from the reference"


@pytest.mark.parametrize("rel", sorted(PORT_SPECIFIC))
def test_copy_differs_only_in_port_specific_parts(rel):
    names, replacements = PORT_SPECIFIC[rel]
    ref, port = _renamed_reference(rel), _port(rel)
    ref_lines, port_lines = ref.splitlines(), port.splitlines()
    ref_ok, port_ok = _spans(ref, names), _spans(port, names)
    bad = []
    matcher = difflib.SequenceMatcher(a=ref_lines, b=port_lines, autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        a, b = ref_lines[i1:i2], port_lines[j1:j2]
        if (a, b) in [(list(x), list(y)) for x, y in replacements]:
            continue
        stray_ref = [i for i in range(i1, i2) if i not in ref_ok and ref_lines[i].strip()]
        stray_port = [j for j in range(j1, j2) if j not in port_ok
                      and not (tag == "insert" and _is_import_or_blank(port_lines[j]))
                      and port_lines[j].strip()]
        if stray_ref or stray_port:
            bad.append((tag, [ref_lines[i] for i in stray_ref], [port_lines[j] for j in stray_port]))
    assert not bad, f"{rel}: differences outside its port-specific parts: {bad}"
    # every listed part exists in the port
    assert all(_spans(port, [n]) for n in names), names


def test_copies_import_the_port_only():
    """The copies import nothing of the JAX package and no jax."""
    for rel in VERBATIM + sorted(PORT_SPECIFIC):
        tree = ast.parse(_port(rel))
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "karpenter_tpu"), (rel, mod)
