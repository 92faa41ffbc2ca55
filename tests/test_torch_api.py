"""The port's API is the JAX package's: an `ast` scan of both packages.

Every public top-level function and class, and every public method of a
public class, of `gorio_tpu/<m>.py` has a namesake in
`gorio_tpu_torch/<m>.py`, and every parameter of the JAX function exists in
its counterpart. What has no counterpart by design is in `EXCEPTIONS`, each
with its reason; a JAX `key` or `rng` parameter is replaced by a
`torch.Generator` (`generator`) or by the draws as tensors, since
`jax.random` cannot be reproduced.

The repo's evaluation drivers in `scripts/` are held the same way: each
ported script's public names and parameters exist in its module under
`gorio_tpu_torch/evaluation/` (`SCRIPTS`); the scripts not ported yet are
listed in `SCRIPTS_LATER` with their ROADMAP item, so that a script added
without a counterpart fails."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "gorio_tpu", ROOT / "gorio_tpu_torch"
SCRIPTS = {
    "recall_benchmark.py": "evaluation/recall.py",
    "accuracy_benchmark.py": "evaluation/accuracy.py",
    "loop_replay.py": "evaluation/loop_replay.py",
    "loop_sweep.py": "evaluation/loop_sweep.py",
    "stream_benchmark.py": "evaluation/stream.py",
    "graph_baseline.py": "evaluation/graph_baseline.py",
    "bench_scaling.py": "evaluation/scaling.py",
    "demo_multihost.py": "evaluation/multihost.py",
    "profile_ndt.py": "evaluation/profile_ndt.py",
    "profile_linearize.py": "evaluation/profile_linearize.py",
    "profile_graph_solve.py": "evaluation/profile_graph_solve.py",
    "profile_ugpm.py": "evaluation/profile_ugpm.py",
    "profile_ugpm2.py": "evaluation/profile_ugpm.py",
    "make_ugpm_golden.py": "evaluation/ugpm_golden.py",
    "diagnose_dispatch_poison.py": "evaluation/dispatch.py",
}
# scripts still to port, each with its ROADMAP item (Queue A): none since A20.7
SCRIPTS_LATER = {}
RANDOM_KEYS = {"key", "rng"}  # replaced by `generator` or explicit draws
# the port module that holds a JAX module's names, where the file differs
MODULES = {"ops/nn_pallas.py": "ops/nn.py"}
EXCEPTIONS = {
    ("graph/factors.py", "empty_graph", "xp"):
        "picks numpy or jnp for the arrays; the port's are torch tensors",
    ("graph/factors.py", "empty_plane_graph", "xp"):
        "picks numpy or jnp for the arrays; the port's are torch tensors",
    ("graph/graph.py", "PoseGraph.freeze", "as_numpy"):
        "host arrays as jit constants; the port freezes onto a `device`",
    ("graph/graph.py", "PoseGraph.freeze_planes", "as_numpy"):
        "host arrays as jit constants; the port freezes onto a `device`",
    ("ops/nn_pallas.py", "nn1_pallas", None):
        "the Pallas entry point; its port is `nn1_best` over the `gorio_nn1` kernel",
    ("ops/nn_pallas.py", "nn1_select_pallas", None):
        "the Pallas entry point; its port is `nn1_select` over the `gorio_nn1_select` kernel",
}


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            + [v for v in (a.vararg, a.kwarg) if v is not None]]


def _public(path):
    """{name: parameters} of the public functions, classes (None) and the
    public methods of public classes ("Class.method") at a module's top."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not sub.name.startswith("_")):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
    return out


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py") if _public(p))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port_file = PORT / MODULES.get(module, module)
    assert port_file.is_file(), f"no gorio_tpu_torch/{MODULES.get(module, module)}"
    port = _public(port_file)
    missing = []
    for name, params in _public(JAX / module).items():
        if (module, name, None) in EXCEPTIONS:
            continue
        if name not in port:
            missing.append(name)
            continue
        missing += [f"{name}({p}=)" for p in params or ()
                    if p not in port[name] and p not in RANDOM_KEYS
                    and (module, name, p) not in EXCEPTIONS]
    assert not missing, f"gorio_tpu/{module}: no counterpart in the port for {missing}"


def test_every_exception_is_still_needed():
    """An entry of `EXCEPTIONS` names a JAX name or parameter that exists
    and that the port does not have."""
    for (module, name, param), reason in EXCEPTIONS.items():
        assert reason
        jax_names = _public(JAX / module)
        assert name in jax_names, (module, name)
        port = _public(PORT / MODULES.get(module, module))
        if param is None:
            assert name not in port, (module, name)
        else:
            assert param in jax_names[name] and param not in port[name], (module, name, param)


def test_every_script_is_ported_or_listed():
    """Each `scripts/*.py` is in `SCRIPTS` or in `SCRIPTS_LATER`, not both,
    and ROADMAP.md names every item of `SCRIPTS_LATER`."""
    have = {p.name for p in (ROOT / "scripts").glob("*.py")}
    assert not set(SCRIPTS) & set(SCRIPTS_LATER)
    assert have == set(SCRIPTS) | set(SCRIPTS_LATER), have ^ (set(SCRIPTS) | set(SCRIPTS_LATER))
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for script, item in SCRIPTS_LATER.items():
        assert item in roadmap and script in roadmap, (script, item)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_every_script_name_has_a_counterpart(script):
    """Every public function, class and method of the script, and every
    parameter, in its port under `gorio_tpu_torch/evaluation/`."""
    port_file = PORT / SCRIPTS[script]
    assert port_file.is_file(), f"no gorio_tpu_torch/{SCRIPTS[script]}"
    port = _public(port_file)
    missing = []
    for name, params in _public(ROOT / "scripts" / script).items():
        if name not in port:
            missing.append(name)
            continue
        missing += [f"{name}({p}=)" for p in params or () if p not in port[name]]
    assert not missing, f"scripts/{script}: no counterpart in the port for {missing}"
