"""Run a reference test module's own cases on both packages.

`run(name, case, pkg)` loads `tests/<name>.py` as a fresh module bound to
package `pkg` — for the port, every `karpenter_tpu` import renamed to
`karpenter_tpu_torch` — and runs one of its cases there with its own
assertions. Its sibling imports (`helpers`, `test_solverd`,
`test_scheduler`) are loaded the same way, and a top-level import of a
module the package lacks is dropped, with the classes that derive from
what it imported (only cases that need none of it are run). The reference's side is a copy of its module too, so the hooks below
never touch the modules pytest collects.

The twin tests compare what the two runs record:
- every `decisions(results)` of tests/test_solverd.py records `decisions`
  below: claims with their pods in order, instance-type options,
  requirements and annotations; pods on existing nodes; pod errors with
  type and message;
- every `Env.schedule` of tests/test_scheduler.py records the same;
- every harness `make_provisioner_harness` built records, after the case,
  the NodeClaim objects in its store (`dataclasses.asdict`), the
  provisioner's pod nominations and its events;
- every Command the disruption controller of tests/test_disruption.py's
  `Env` parks for validation or starts (`command_record`: decision,
  candidate names in order, each replacement's instance-type options and
  requirements), every `command_signature` of tests/test_frontier.py,
  and, after the case, every `Env` / `Harness` (tests/test_candidate_oracle.py)
  built: the NodeClaim objects in its store and its events in order;
- every `Operator.run_once()` summary, and after the case each Operator's
  events in order and its reconcilers' error counts;
- after the case, every object of every store the module built on a
  FakeClock (`repr`, by kind and key);
- every simulator run (`sim.harness.Simulation.run`,
  `sim.fleet.FleetSimulation.run`, however the case reaches it): its
  event-log digest, its event log and its report outside the port's
  `sim.harness.DEVICE_SPECIFIC` and `VOLATILE` sections.

A case parametrized by `pytest.mark.parametrize` is one case a parameter
set (`Class::method[i]`), and the module's autouse fixtures run around it.

Each run installs the same uid source (`apis.core.set_uid_source`), one
seeded source for leader identities and command ids, and restarts the
name, hostname and placeholder counters, so the two packages draw the same
names, and the delta counters, so their reports count the same. On the reference's side `ffd.STRICT` is set: a fault there raises
instead of falling back to the host loop. On the port's side engines are
built on the CPU (`device="cpu"`) wherever a case builds one without a
device: a `CatalogEngine`, the Provisioner's (so the Operator's) and the
solver daemon's default engine factories, and `python -m
karpenter_tpu_torch` in process and as a subprocess (`--device cpu`),
and `python -m karpenter_tpu_torch.sim` in process (`--device cpu`).

A few lines of a reference case use jax itself (a jit program, its
caches); the port's leg runs such a line as `PORT_LINES` gives it, with the
reason beside it.

Every bucket an AOT warm start walks (`aot.compiler._ensure_executable`) is
recorded: the kernel, the bucket's dims (the first operand's shape; a row
batch's row count), its scope and donation fields, and whether it was
already loaded, a cache hit or a fresh compile. The reference walks a row
rung once for each target set (the types', the offerings'), the port once
for both (its row batch is one launch): the reference's second record of a
row rung is folded into the first.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import inspect
import io
import itertools
import os
import pathlib
import random
import re
import sys
import tempfile
import types

import pytest

J, T = "karpenter_tpu", "karpenter_tpu_torch"
TESTS = os.path.dirname(os.path.abspath(__file__))
SIBLINGS = (
    "helpers", "test_solverd", "test_scheduler", "test_disruption",
    "test_metrics_exposition", "expectations", "test_sim_faults",
)


class Leg:
    """What one run of a case records."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.obs: list = []
        self.harnesses: list = []
        self.envs: list = []
        self.stores: list = []
        self.operators: list = []


_LEG: list = []


def _record(item) -> None:
    if _LEG:
        _LEG[-1].obs.append(item)


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def twin_name(name: str, pkg: str) -> str:
    return f"_twin_{'port' if pkg == T else 'ref'}_{name}"


def _exists(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:
        return False


class _Rewrite(ast.NodeTransformer):
    """Sibling imports to their twins; top-level imports of modules the
    package lacks dropped."""

    def __init__(self, pkg: str):
        self.pkg = pkg

    def visit_ImportFrom(self, node):
        if node.module in SIBLINGS:
            node.module = twin_name(node.module, self.pkg)
        return node


# (module, line of the reference case, the port's line): the reference's
# line uses jax itself (a jit program, its caches); the port's leg runs the
# line as given here, with the reason beside it
PORT_LINES = [
    # the AOT cases: the port has no jit caches to drop (a second boot
    # loads the kernel libraries it finds), and its named dispatch takes a
    # plain callable on torch tensors
    (
        "test_aot",
        "        jax.clear_caches()",
        "        pass  # port: no jit caches; built kernel libraries stay loaded",
    ),
    (
        "test_aot",
        "        f = jax.jit(lambda x: x * 2.0)",
        "        f = lambda x: x * 2.0  # port: the named dispatch calls a plain callable",
    ),
    (
        "test_aot",
        "        import jax.numpy as jnp",
        "        import torch as jnp  # port: on torch tensors",
    ),
    (
        "test_perf_floor",
        "            jax.clear_caches()",
        "            pass  # port: no jit caches; built kernel libraries stay loaded",
    ),
    # the efficiency views: the dispatched program is a plain callable, its
    # cost entry an executable of the port's AOT compiler
    (
        "test_serving_debug",
        "        f = jax.jit(lambda x: x @ x)",
        "        f = lambda x: x @ x  # port: a plain callable",
    ),
    (
        "test_serving_debug",
        "            f.lower(jax.ShapeDtypeStruct((8, 8), np.float32)).compile(),",
        "            _port_executable(f),  # port: the AOT compiler's executable",
    ),
]


def _port_executable(fn):
    """An 8x8 float32 matmul bucket as the port's AOT compiler records it
    (aot/compiler.Executable): its cost is 2 * 8^3 operations and the two
    operands' and the output's bytes."""
    import torch

    compiler = _m(T, "aot.compiler")
    spec = compiler.OperandSpec((8, 8), "float32", "cpu")
    return compiler.Executable(
        "spec.eff", fn, (spec,), "8x8", {"flops": 2.0 * 8 ** 3, "bytes accessed": 3.0 * 8 * 8 * 4},
        torch.device("cpu"),
    )


def _source(name: str, pkg: str) -> str:
    with open(os.path.join(TESTS, f"{name}.py")) as f:
        src = f.read()
    if pkg == T:
        src = re.sub(r"\bkarpenter_tpu\b", T, src)
        for module_, ref_line, port_line in PORT_LINES:
            if module_ == name:
                assert src.count(ref_line + "\n") >= 1, (name, ref_line)
                src = src.replace(ref_line + "\n", port_line + "\n")
    return src


@functools.lru_cache(maxsize=None)
def module(name: str, pkg: str) -> types.ModuleType:
    """tests/<name>.py bound to `pkg`, with the hooks installed."""
    tree = ast.parse(_source(name, pkg))
    tree = _Rewrite(pkg).visit(tree)
    keep, dropped = [], set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(pkg + "."):
            if not _exists(node.module):
                dropped.update(a.asname or a.name for a in node.names)
                continue
        if isinstance(node, ast.ClassDef) and any(
            isinstance(b, ast.Name) and b.id in dropped for b in node.bases
        ):
            continue  # a subclass of what the package lacks
        keep.append(node)
    tree.body = keep
    ast.fix_missing_locations(tree)
    mod = types.ModuleType(twin_name(name, pkg))
    mod.__file__ = os.path.join(TESTS, f"{name}.py")
    mod._port_executable = _port_executable
    sys.modules[mod.__name__] = mod
    for sibling in SIBLINGS:
        if sibling != name and re.search(rf"^\s*from {sibling} import", _source(name, pkg), re.M):
            module(sibling, pkg)
    exec(compile(tree, f"{mod.__file__} [{pkg}]", "exec"), mod.__dict__)
    _install_hooks(mod, name, pkg)
    return mod


# -- hooks -------------------------------------------------------------------


def decisions(results) -> tuple:
    """The whole decision of a solve, in order."""
    claims = [
        (
            nc.nodepool_name,
            [p.metadata.name for p in nc.pods],
            [it.name for it in nc.instance_type_options],
            sorted(
                (r.key, r.complement, sorted(r.values), r.greater_than, r.less_than, r.min_values)
                for r in nc.requirements
            ),
            sorted(nc.annotations.items()),
        )
        for nc in results.new_node_claims
    ]
    existing = sorted(
        (en.name(), [p.metadata.name for p in en.pods])
        for en in results.existing_nodes
        if en.pods
    )
    errors = sorted(
        (p.metadata.name, type(e).__name__, str(e)) for p, e in results.pod_errors.items()
    )
    return claims, existing, errors


def store_snapshot(harness) -> dict:
    """The NodeClaims a harness's store holds, its provisioner's pod
    nominations and its events."""
    clock, store, provider, cluster, informer, prov = harness
    return {
        "nodeclaims": sorted(
            (dataclasses.asdict(c) for c in store.list("NodeClaim")),
            key=lambda c: c["metadata"]["name"],
        ),
        "nominations": sorted(cluster.pod_to_node_claim.items()),
        "events": sorted(
            (
                getattr(getattr(e.involved_object, "metadata", None), "name", ""),
                e.type, e.reason, e.message,
            )
            for e in prov.recorder.events
        ),
    }


def command_record(cmd) -> tuple:
    """A disruption Command's decision: the decision, the candidates by
    name in order, each replacement's instance-type options and
    requirements."""
    return (
        cmd.decision(),
        [c.name() for c in cmd.candidates],
        [
            (
                [it.name for it in rep.node_claim.instance_type_options],
                sorted(
                    (r.key, r.complement, sorted(r.values), r.greater_than,
                     r.less_than, r.min_values)
                    for r in rep.node_claim.requirements
                ),
            )
            for rep in cmd.replacements
        ],
    )


def env_snapshot(env) -> dict:
    """The NodeClaim objects an env's store holds and its events, in the
    order they were published."""
    return {
        "nodeclaims": sorted(
            (dataclasses.asdict(c) for c in env.store.list("NodeClaim")),
            key=lambda c: c["metadata"]["name"],
        ),
        "events": [
            (
                getattr(getattr(e.involved_object, "metadata", None), "name", ""),
                e.type, e.reason, e.message,
            )
            for e in env.recorder.events
        ],
    }


def store_objects(store) -> dict:
    """Every object a store holds, by kind, in key order (`repr`: the
    dataclasses' fields)."""
    return {
        kind: [(key, repr(obj)) for key, obj in sorted(bucket.items())]
        for kind, bucket in sorted(store._objects.items())
    }


def operator_snapshot(op) -> dict:
    """An Operator's events in the order they were published, and its
    reconcilers' error counts."""
    return {
        "events": [
            (
                getattr(getattr(e.involved_object, "metadata", None), "name", ""),
                e.type, e.reason, e.message,
            )
            for e in op.recorder.events
        ],
        "errors": sorted(op.harness._errors.items()),
    }


def _recorded_store(Store):
    """Store, recorded: a factory of the package's own class, so the store
    still crosses a socket by pickle."""

    @functools.wraps(Store)
    def build(*args, **kwargs):
        store = Store(*args, **kwargs)
        if _LEG:
            _LEG[-1].stores.append(store)
        return store

    return build


def _recorded_operator(Operator):
    class RecordedOperator(Operator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if _LEG:
                _LEG[-1].operators.append(self)

        def run_once(self):
            out = super().run_once()
            _record(("pass", out))
            return out

    RecordedOperator.__name__ = RecordedOperator.__qualname__ = Operator.__name__
    return RecordedOperator


class _CpuSubprocess:
    """`subprocess` for a test module in the port: `python -m
    karpenter_tpu_torch` gets `--device cpu`."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def run(self, args, *a, **kw):
        args = list(args)
        if args[1:3] == ["-m", T] and "--device" not in args:
            args[3:3] = ["--device", "cpu"]
        return self._real.run(args, *a, **kw)


def _cpu_main(main):
    """`__main__.main` of the port with `--device cpu` unless given."""

    @functools.wraps(main)
    def run(argv=None, *args, **kwargs):
        argv = list(sys.argv[1:] if argv is None else argv)
        if "--device" not in argv:
            argv = ["--device", "cpu"] + argv
        return main(argv, *args, **kwargs)

    return run


def _recorded_env(cls):
    init = cls.__init__

    @functools.wraps(init)
    def __init__(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if _LEG:
            _LEG[-1].envs.append(self)

    cls.__init__ = __init__


def _cpu_engine(CatalogEngine):
    @functools.wraps(CatalogEngine)
    def build(*args, **kwargs):
        kwargs.setdefault("device", "cpu")
        return CatalogEngine(*args, **kwargs)

    return build


def port_provisioner_harness(options=None, instance_types=None):
    """tests/helpers.make_provisioner_harness in the port: the engines on
    the CPU."""
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        Provisioner,
        default_engine_factory,
    )
    from karpenter_tpu_torch.events.recorder import Recorder
    from karpenter_tpu_torch.operator.options import Options as _Options
    from karpenter_tpu_torch.runtime.store import Store
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.state.informer import StateInformer
    from karpenter_tpu_torch.utils.clock import FakeClock

    options = options or _Options()
    clock = FakeClock()
    store = Store(clock=clock)
    provider = FakeCloudProvider(instance_types)
    cluster = Cluster(clock, store, provider)
    informer = StateInformer(store, cluster)
    recorder = Recorder(clock=clock)
    factory = (
        default_engine_factory(
            shard_devices=options.solver_pod_shard_axis, device="cpu"
        )
        if options.solver_backend == "tpu"
        else None
    )
    prov = Provisioner(
        store, provider, cluster, recorder, clock, options, engine_factory=factory
    )
    return clock, store, provider, cluster, informer, prov


def _install_hooks(mod, name: str, pkg: str) -> None:
    if pkg == T:
        if "CatalogEngine" in mod.__dict__:
            mod.CatalogEngine = _cpu_engine(mod.CatalogEngine)
        if "subprocess" in mod.__dict__:
            mod.subprocess = _CpuSubprocess(mod.subprocess)
    if mod.__dict__.get("Store") is _m(pkg, "runtime.store").Store:
        mod.Store = _recorded_store(mod.Store)
    if mod.__dict__.get("Operator") is _m(pkg, "operator.operator").Operator:
        mod.Operator = _recorded_operator(mod.Operator)
    if name == "test_disruption":
        _recorded_env(mod.Env)

        class RecordedController(mod.DisruptionController):
            def reconcile(self):
                before = self._pending
                out = super().reconcile()
                if self._pending is not None and self._pending is not before:
                    _record(("parked", command_record(self._pending[0])))
                return out

        class RecordedQueue(mod.DisruptionQueue):
            def start_command(self, cmd):
                _record(("started", command_record(cmd)))
                return super().start_command(cmd)

        mod.DisruptionController = RecordedController
        mod.DisruptionQueue = RecordedQueue
    if name == "test_candidate_oracle":
        _recorded_env(mod.Harness)
    if name == "test_frontier":
        signature = mod.command_signature

        def recorded_signature(cmd):
            out = signature(cmd)
            _record(("command", out))
            return out

        mod.command_signature = recorded_signature
    if name == "helpers":
        make = port_provisioner_harness if pkg == T else mod.make_provisioner_harness

        def make_provisioner_harness(options=None, instance_types=None):
            harness = make(options, instance_types)
            if _LEG:
                _LEG[-1].harnesses.append(harness)
            return harness

        mod.make_provisioner_harness = make_provisioner_harness
    if name == "test_scheduler":
        schedule = mod.Env.schedule

        def recorded_schedule(self, pods, timeout=60.0):
            results = schedule(self, pods, timeout=timeout)
            _record(("schedule", decisions(results)))
            return results

        mod.Env.schedule = recorded_schedule
    if name == "test_solverd":
        original = mod.decisions

        def recorded(results):
            _record(("decisions", decisions(results)))
            return original(results)

        mod.decisions = recorded


# -- running a case ------------------------------------------------------------


def cases(name: str, classes=None) -> list[str]:
    """The test cases of tests/<name>.py ("Class::method" or "function",
    "Class::method[i]" for the i-th parameter set of a parametrized one),
    in file order; `classes` keeps only those classes' cases."""
    tree = ast.parse(_source(name, J))
    out = []
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            if classes is not None and node.name not in classes:
                continue
            out += [
                f"{node.name}::{f.name}" for f in node.body
                if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")
            ]
        elif isinstance(node, ast.FunctionDef) and node.name.startswith("test_") and classes is None:
            out.append(node.name)
    expanded = []
    for case in out:
        params = _parameter_sets(_case_function(module(name, J), case))
        expanded += [case] if params is None else [f"{case}[{i}]" for i in range(len(params))]
    return expanded


def _case_function(mod, case: str):
    """The unbound function of a case (its parameter index dropped)."""
    case = case.split("[")[0]
    if "::" in case:
        cls_name, meth = case.split("::")
        return getattr(mod.__dict__[cls_name], meth)
    return mod.__dict__[case]


def _parameter_sets(fn):
    """[{argname: value}, ...] of a function's parametrize marks (their
    product, the last mark innermost), or None when it has none."""
    marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
    if not marks:
        return None
    sets = [{}]
    for mark in reversed(marks):
        names, values = mark.args[0], list(mark.args[1])
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        rows = [dict(zip(names, v if len(names) > 1 else (v,))) for v in values]
        sets = [{**a, **b} for a in sets for b in rows]
    return sets


def _autouse(mod) -> list:
    """The module's autouse fixtures."""
    return [
        fx for fx in mod.__dict__.values()
        if getattr(getattr(fx, "_fixture_function_marker", None), "autouse", False)
    ]


class _Capsys:
    """pytest's `capsys`: what the case prints, read back."""

    def __init__(self, stack: contextlib.ExitStack):
        self._out, self._err = io.StringIO(), io.StringIO()
        stack.enter_context(contextlib.redirect_stdout(self._out))
        stack.enter_context(contextlib.redirect_stderr(self._err))

    def readouterr(self):
        out, err = self._out.getvalue(), self._err.getvalue()
        for buf in (self._out, self._err):
            buf.seek(0)
            buf.truncate()
        return types.SimpleNamespace(out=out, err=err)


class _TmpPathFactory:
    """pytest's `tmp_path_factory`, under the case's temporary directory."""

    def __init__(self, tmp: pathlib.Path):
        self._tmp = tmp

    def mktemp(self, basename: str) -> pathlib.Path:
        return pathlib.Path(tempfile.mkdtemp(prefix=basename, dir=self._tmp))


def _fixture(mod, name: str, mp, tmp: pathlib.Path, stack: contextlib.ExitStack,
             inst=None):
    """A fixture's value (a class's fixture method bound to `inst`); a
    generator fixture's teardown goes on `stack`."""
    if name == "monkeypatch":
        return mp
    if name == "tmp_path":
        return tmp
    if name == "tmp_path_factory":
        return _TmpPathFactory(tmp)
    if name == "capsys":
        return _Capsys(stack)
    fx = getattr(type(inst), name, None) if inst is not None else None
    if fx is None:
        fx = mod.__dict__[name]
    fn = getattr(fx, "_get_wrapped_function", None)
    body = fn() if fn else fx.__wrapped__
    params = list(inspect.signature(body).parameters)
    args = [inst] if params[:1] == ["self"] else []
    out = body(*args, *[
        _fixture(mod, p, mp, tmp, stack, inst) for p in params[len(args):]
    ])
    if inspect.isgenerator(out):
        value = next(out)
        stack.callback(next, out, None)
        return value
    return out


def reset_aot(pkg: str) -> None:
    """What an AOT warm start leaves behind in a process, dropped: the
    runtime's ladder, cache and executables, its off-ladder record, the
    efficiency cost tables (a simulator report carries their size) and the
    Provisioner's content-cached engines (a cached engine keeps its
    ladder)."""
    rt = _m(pkg, "aot.runtime")
    rt.configure(None, None)
    rt.clear_executables()
    rt.reset_off_ladder()
    _m(pkg, "observability.efficiency").tables().reset()
    _m(pkg, "controllers.provisioning.provisioner")._ENGINE_CONTENT_CACHE.clear()


def reset(pkg: str, seed: int = 0) -> None:
    """The same names and uids in either package."""
    _m(pkg, "apis.core").set_uid_source(random.Random(seed))
    _m(pkg, "scheduler.nodeclaim")._hostname_counter = itertools.count(1)
    _m(pkg, "ops.ffd")._placeholder_counter = itertools.count(1)
    helpers = sys.modules.get(twin_name("helpers", pkg))
    if helpers is not None:
        helpers._counter[0] = 0


def _seeded_uuids(mp, pkg: str, seed: int = 1) -> None:
    """The same leader identities and command ids in either package."""
    import uuid

    rng = random.Random(seed)
    seeded = types.SimpleNamespace(uuid4=lambda: uuid.UUID(int=rng.getrandbits(128), version=4))
    for name in ("operator.leaderelection", "controllers.disruption.types"):
        mp.setattr(_m(pkg, name), "uuid", seeded)


def _cpu_factories(mp) -> None:
    """The port's engines on the CPU wherever one is built without a
    device: the Provisioner's (and so the Operator's) default engine
    factory, the solver daemon's, `python -m karpenter_tpu_torch`, and a
    `CatalogEngine` a case imports inside its body."""
    prov = _m(T, "controllers.provisioning.provisioner")
    transport = _m(T, "solverd.transport")
    cli = _m(T, "__main__")
    for module_, name in ((prov, "default_engine_factory"),
                          (transport, "_default_engine_factory")):
        real = getattr(module_, name)

        def factory(shard_devices=0, device=None, _real=real):
            return _real(shard_devices, device="cpu" if device is None else device)

        mp.setattr(module_, name, factory)
    mp.setattr(cli, "main", _cpu_main(cli.main))
    sim_cli = _m(T, "sim.__main__")
    mp.setattr(sim_cli, "main", _cpu_main(sim_cli.main))
    catalog = _m(T, "ops.catalog")

    class CpuCatalogEngine(catalog.CatalogEngine):
        def __init__(self, *args, **kwargs):
            kwargs.setdefault("device", "cpu")
            super().__init__(*args, **kwargs)

    CpuCatalogEngine.__name__ = CpuCatalogEngine.__qualname__ = "CatalogEngine"
    mp.setattr(catalog, "CatalogEngine", CpuCatalogEngine)


def _recorded_sims(mp, pkg: str) -> None:
    """Every simulator run of the leg, recorded: digest, event log, and the
    report outside the port's DEVICE_SPECIFIC sections and its measured
    host-stall fraction (VOLATILE, a ratio of walls where a batch went to
    the device)."""
    harness = _m(T, "sim.harness")
    for module_, cls_name in (("sim.harness", "Simulation"), ("sim.fleet", "FleetSimulation")):
        cls = getattr(_m(pkg, module_), cls_name)

        def run(self, _real=cls.run):
            result = _real(self)
            _record((
                "sim", result.digest, result.log.to_jsonl(),
                harness.report_without(result.report, harness.DEVICE_SPECIFIC + harness.VOLATILE),
            ))
            return result

        mp.setattr(cls, "run", run)


def _recorded_warm_starts(mp, pkg: str) -> None:
    """Every bucket an AOT warm start walks, recorded with its outcome (see
    the module docstring)."""
    compiler = _m(pkg, "aot.compiler")
    real = compiler._ensure_executable

    def ensure(plan, catalog_hash, ladder, cache, registry, summary):
        before = dict(summary)
        real(plan, catalog_hash, ladder, cache, registry, summary)
        outcome = sorted(k for k in summary if k != "buckets" and summary[k] != before[k])
        kernel, sig = plan[0], plan[3]
        dims = sig.split(",")[0]
        if kernel == "catalog.row_compat":
            dims = dims.split("x")[0]
        scope = plan[4] if len(plan) > 4 else ""
        donation = plan[5] if len(plan) > 5 else ""
        item = ("aot-bucket", kernel, dims, scope, donation, outcome)
        if (
            pkg == J and kernel == "catalog.row_compat" and _LEG
            and _LEG[-1].obs and _LEG[-1].obs[-1] == item
        ):
            return  # the rung's second target set: one launch in the port
        _record(item)

    mp.setattr(compiler, "_ensure_executable", ensure)


@contextlib.contextmanager
def leg(pkg: str):
    """One run's recording, names and settings."""
    rec = Leg(pkg)
    _LEG.append(rec)
    with pytest.MonkeyPatch.context() as mp:
        if pkg == J:
            mp.setattr(_m(J, "ops.ffd"), "STRICT", True)
        else:
            _cpu_factories(mp)
        _seeded_uuids(mp, pkg)
        _recorded_sims(mp, pkg)
        _recorded_warm_starts(mp, pkg)
        # the delta counters a simulation report carries are the process's
        # (report["solver"]["delta"]): count from 0, as a fresh process does
        delta = _m(pkg, "ops.delta")
        mp.setattr(delta, "COUNTERS", dict.fromkeys(delta.COUNTERS, 0))
        reset(pkg)
        try:
            yield rec
        finally:
            _m(pkg, "apis.core").set_uid_source(None)
            _LEG.pop()


class _PortMonkeyPatch(pytest.MonkeyPatch):
    """The port has no `ffd.STRICT`: it always behaves as the reference
    does under STRICT = True, so a case's `setattr(ffd, "STRICT", True)`
    has nothing to set there."""

    def setattr(self, target, name, value=None, raising=True):
        if target is _m(T, "ops.ffd") and name == "STRICT" and value is True:
            return
        super().setattr(target, name, value, raising=raising)


def _call_method_hook(hook, fn) -> None:
    """pytest's setup_method / teardown_method, with or without the
    method argument."""
    if inspect.signature(hook).parameters:
        hook(fn)
    else:
        hook()


def run(name: str, case: str, pkg: str) -> list:
    """Run one case of tests/<name>.py in `pkg`; returns what it recorded."""
    mod = module(name, pkg)
    mp = _PortMonkeyPatch() if pkg == T else pytest.MonkeyPatch()
    with leg(pkg) as rec, contextlib.ExitStack() as stack, \
            tempfile.TemporaryDirectory() as tmp:
        stack.callback(mp.undo)
        base, _, index = case.partition("[")
        inst = None
        if "::" in base:
            cls_name, meth = base.split("::")
            inst = mod.__dict__[cls_name]()
            fn = getattr(inst, meth)
            if hasattr(inst, "setup_method"):
                _call_method_hook(inst.setup_method, fn)
            if hasattr(inst, "teardown_method"):
                stack.callback(_call_method_hook, inst.teardown_method, fn)
        else:
            fn = mod.__dict__[base]
        params = _parameter_sets(_case_function(mod, base))
        params = params[int(index.rstrip("]"))] if index else {}
        for fx in _autouse(mod):
            body = fx._get_wrapped_function()
            out = body(**{
                p: _fixture(mod, p, mp, pathlib.Path(tmp), stack, inst)
                for p in inspect.signature(body).parameters
            })
            if inspect.isgenerator(out):
                next(out)
                stack.callback(next, out, None)
        kwargs = {
            p: params[p] if p in params
            else _fixture(mod, p, mp, pathlib.Path(tmp), stack, inst)
            for p in inspect.signature(fn).parameters
        }
        fn(**kwargs)
        for harness in rec.harnesses:
            rec.obs.append(("store", store_snapshot(harness)))
        for env in rec.envs:
            rec.obs.append(("env", env_snapshot(env)))
        for op in rec.operators:
            rec.obs.append(("operator", operator_snapshot(op)))
        for store in rec.stores:
            if isinstance(store.clock, _m(pkg, "utils.clock").FakeClock):
                rec.obs.append(("objects", store_objects(store)))
    return rec.obs


def twin(name: str, case: str) -> tuple[list, list]:
    """The case on the reference, then on the port; both must pass their
    assertions, and what they record must be equal."""
    ref = run(name, case, J)
    port = run(name, case, T)
    assert port == ref
    return ref, port
