"""The port's copies of reference modules against the reference files.

A verbatim copy must equal the reference byte for byte once the package name
is renamed (`karpenter_tpu` -> `karpenter_tpu_torch`). A copy with CUDA
replacements may differ only inside its port-specific parts, listed here by
name: module-level functions, classes, methods (`Class.method`), a class's
docstring (`Class.__doc__`), the module docstring (`__doc__`), assignments
(with the comment block above them), and import lines the port adds. A
reference part the port leaves out is listed with a leading `-`. Every
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
    "aot/ladder.py",
    "aot/cache.py",
    "observability/slo.py",
    "observability/flight.py",
    "ops/topo_counts.py",
    "tracing/journey.py",
    "state/informer.py",
    "cloudprovider/fake.py",
    "scheduler/volumetopology.py",
    "controllers/__init__.py",
    "controllers/provisioning/__init__.py",
    "controllers/provisioning/batcher.py",
    "solverd/__init__.py",
    "solverd/api.py",
    "solverd/queue.py",
    "solverd/service.py",
    "ops/frontier.py",
    "controllers/disruption/__init__.py",
    "controllers/disruption/types.py",
    "controllers/disruption/validation.py",
    "controllers/disruption/consolidation.py",
    "controllers/disruption/queue.py",
    "utils/node.py",
    "apis/nodeoverlay.py",
    "runtime/journal.py",
    "cloudprovider/metrics.py",
    "cloudprovider/overlay.py",
    "cloudprovider/breaker.py",
    "cloudprovider/kwok/provider.py",
    "controllers/nodeoverlay.py",
    "controllers/nodepool_controllers.py",
    "controllers/nodeclaim/__init__.py",
    "controllers/nodeclaim/lifecycle.py",
    "controllers/nodeclaim/disruption.py",
    "controllers/nodeclaim/gc.py",
    "controllers/node/__init__.py",
    "controllers/node/health.py",
    "controllers/node/termination.py",
    "controllers/binding.py",
    "controllers/metrics_controllers.py",
    "operator/leaderelection.py",
    "operator/operator.py",
    "operator/serving.py",
    "sim/__init__.py",
    "sim/events.py",
    "sim/trace.py",
    "sim/scenarios/__init__.py",
    "sim/accounting.py",
    "sim/faults.py",
    "solverd/fleet.py",
]

# module -> the port-specific parts (see the module docstring), and the
# replacements of lines inside a shared function: (reference lines, port
# lines), each matched exactly
PORT_SPECIFIC = {
    # the docstrings say what an executable and a cache entry are here
    "aot/__init__.py": (["__doc__"], []),
    "aot/runtime.py": (["__doc__"], []),
    # the compiler: the toolchain fingerprint names torch, CUDA, nvcc, the
    # device and the nvcc flags; operand specs in place of
    # ShapeDtypeStructs; the port's executables and cache records; a
    # KernelError of a warm launch fails the boot; the cost formulas of
    # chip_smoke.py's bound column; no x64 lowering, no RTT probe
    "aot/compiler.py": (
        ["__doc__", "_ENGINE_DEVICE", "_NVCC_VERSION", "_nvcc_version", "_device_name",
         "_toolchain_fingerprint", "words", "row_compat_ops", "membership_ops", "cube_ops",
         "solve_block_ops", "scan_ops", "OperandSpec", "_Deferred", "_sds", "_dtype_name",
         "_materialize", "_nbytes", "Executable", "_plan", "_cost",
         "_cube_plans", "_resident_rows", "_row_compat_plans", "_mesh_shardings",
         "_sharded_cube_plans", "_sharded_solve_block_plans", "-_X64Lower",
         "_solve_scan_plans", "_solve_block_plans", "_ensure_executable", "_library_dir",
         "warm_start"],
        [(["import pickle"], ["import json", "import subprocess"])],
    ),
    "observability/kernels.py": (["sample_device_memory"], []),
    # the catalog engine on a torch device: the row batch's one launch
    # against both target sets and the sweep's kt_cube over the resident
    # rows by index (`_row_compat`, `_cube`, the resident matrices, the
    # mesh's gathered rows); the host route with the reference's decisions,
    # its RTT probed and cached per torch device (`_RTT_CACHE`,
    # `device_rtt_s`, `_use_device`) and a host batch's rows appended to the
    # resident matrices; the reference's [O, I] owner one-hot is not built
    # (the host sweep's record names it by shape)
    "ops/catalog.py": (
        ["__doc__", "_row_compat", "_cube", "_RTT_CACHE", "device_rtt_s", "_card_keeps_work",
         "_use_device",
         "CatalogEngine.__doc__", "CatalogEngine.__init__", "CatalogEngine._encode_catalog",
         "CatalogEngine._ensure_rows", "CatalogEngine._row_compat_device",
         "CatalogEngine._row_compat_host", "CatalogEngine._append_resident",
         "CatalogEngine._dev", "CatalogEngine._mesh_dev", "CatalogEngine._host_words",
         "CatalogEngine._to_device", "CatalogEngine._set_args", "CatalogEngine.warmup",
         "CatalogEngine.state_arrays", "CatalogEngine.feasibility",
         "CatalogEngine._host_sweep", "CatalogEngine._gather_rows"],
        [(["import jax.numpy as jnp"], [])],
    ),
    # the fence; a KernelError of an installed executable fails the dispatch
    "tracing/kernel.py": (
        ["__doc__", "_cache_size", "_cuda_devices", "_fence"],
        [
            (
                [
                    "            try:",
                    "                import jax",
                    "",
                    "                jax.block_until_ready(out)",
                    "            except Exception:  # noqa: BLE001 — host twins return plain numpy",
                    "                pass",
                ],
                ["            _fence(out)"],
            ),
            (
                [],
                [
                    "            except devmod.KernelError:",
                    "                # port: a device fault of an installed executable fails the",
                    "                # dispatch — launching again lazily would cover it",
                    "                raise",
                ],
            ),
        ],
    ),
    "observability/efficiency.py": (
        ["__doc__", "DEVICE_PEAKS", "_device_peaks", "DeviceProfiler.__doc__",
         "DeviceProfiler.available", "DeviceProfiler.activities", "DeviceProfiler._run"],
        [],
    ),
    # the dedupe map pruned when it has doubled, not on every publish
    "events/recorder.py": (["Recorder._maybe_evict"], []),
    # "tpu" keeps its name and means the CUDA engine
    "operator/options.py": ([], [(
        ['    solver_backend: str = "tpu"  # "tpu" | "host"'],
        ['    solver_backend: str = "tpu"  # "tpu" | "host" (port: "tpu" is the CUDA engine)'],
    )]),
    # the mesh builder is mesh.build_solver_mesh; the engines' device; a
    # CPU engine's mesh repeats the CPU; a KernelError of the AOT warm
    # start fails the boot
    "controllers/provisioning/provisioner.py": (
        ["_build_solver_mesh", "_engine_mesh", "default_engine_factory",
         "Provisioner._warm_engine"], [],
    ),
    # the daemon's factory takes the device; a failed engine build (a
    # KernelError of its AOT warm start too) is the request's error, never a
    # host-loop answer; a KernelError crosses the wire typed
    "solverd/transport.py": (
        ["_default_engine_factory", "_ERROR_TYPES"],
        [(
            [
                "            try:",
                "                scheduler.engine = self.engine_factory(catalog)",
                "            except Exception:  # noqa: BLE001 — host path is decision-identical",
                "                scheduler.engine = None",
            ],
            [
                "            # port: a failed engine build is the request's error (its type",
                "            # rides the error reply) — a daemon that owns the card never",
                "            # answers from the host loop instead",
                "            scheduler.engine = self.engine_factory(catalog)",
            ],
        )],
    ),
    # --device
    "solverd/__main__.py": (["main"], []),
    # a KernelError on any probe of a frontier round fails the compute
    # before the walk; the walk's comments say so; reconcile's comment
    # says a KernelError is not a shed
    "controllers/disruption/helpers.py": (["FrontierSimulator.solve_batch"], []),
    "controllers/disruption/methods.py": (
        ["MultiNodeConsolidation._probe_verdict", "SingleNodeConsolidation.compute_command"],
        [],
    ),
    "controllers/disruption/controller.py": (["Controller.reconcile"], []),
    # a KernelError is counted as any error is, then raised out of the pass
    "operator/harness.py": (["ReconcilerHarness._run"], []),
    # --device; a KernelError stops the loop with a nonzero exit
    "__main__.py": (["_port_args", "main"], []),
    # the run's device through every engine rebuild; the RTT pin's comment
    # states no figure of the reference's hardware; no jit caches; a
    # KernelError from a dying client's close() raised; the report sections
    # that differ from the reference's by design
    "sim/harness.py": (
        ["PINNED_RTT_S", "Simulation._engine_factory", "Simulation._restart_solverd",
         "Simulation._crash_restart", "run_scenario", "_ROW_RUNG", "DEVICE_SPECIFIC", "VOLATILE",
         "report_without"],
        [
            ([], ["        device=None,"]),
            ([], [
                "        # port: the device the run's engines are built on, through every",
                '        # rebuild (solverd restart, crash restart): None is the card, "cpu"',
                "        # the plain versions of the kernels",
                "        self.device = device",
            ]),
            (
                ["            self.store, self.provider, clock=self.clock, options=self.options"],
                [
                    "            self.store, self.provider, clock=self.clock, options=self.options,",
                    "            engine_factory=self._engine_factory(),",
                ],
            ),
        ],
    ),
    # every cell on the run's device
    "sim/fleet.py": (
        ["run_fleet_scenario"],
        [
            ([], ["        device=None,"]),
            ([], [
                "        # port: `device`, every cell's engines' device (None: the card). The",
                "        # replicas' services own no engine: a request's scheduler carries",
                "        # its cell's engine, so the pool solves on the cells' device",
            ]),
            ([], ["                device=device,"]),
        ],
    ),
    # --device; a KernelError ends the run with a nonzero exit and the
    # flight dump
    "sim/__main__.py": (["__doc__", "main"], []),
    # a KernelError in the primed sweep fails the batch's requests; a
    # counter born during a solve (a scan decline reason seen for the first
    # time) starts from 0
    "solverd/coalescer.py": (
        ["Coalescer._prime"],
        [(
            ["                    name: value - base[name]"],
            ["                    name: value - base.get(name, 0)  # port: a counter born in the solve"],
        )],
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
            if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == name:
                return node
        return None

    for name in names:
        parts = name.lstrip("-").split(".")
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
    # every listed part exists in the port, but those it leaves out, which
    # exist in the reference only
    assert all(bool(_spans(port, [n])) != n.startswith("-") for n in names), names
    assert all(_spans(ref, [n]) for n in names if n.startswith("-")), names


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
