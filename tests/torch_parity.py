"""Re-run a reference test module's cases against the port's copies.

The port's numpy-only modules (cluster/, obs/, runtime/) are copies of the
reference's.  ``reference_cases(module)`` lists the module's test cases
(one per parametrize combination) that reach none of ``REFERENCE_ONLY``
(names whose port counterpart has another interface, or none);
``run_case`` runs one of them with every object of the JAX package
swapped for the port's object of the same module path and name (the
reference's own test files already run the cases as they are).  The
module's own helper functions and classes are rebound to the swapped
globals, and an ``import`` inside them resolves to the port, so a helper
the case calls sees the port too.  With ``properties=True`` the module's
hypothesis tests are listed too: each runs its own strategies and
settings, its body rebound to the port.
"""
from __future__ import annotations

import ast
import builtins
import functools
import importlib
import inspect
import itertools
import types

import pytest

# the JAX runtime and the objects whose port has another interface: a case
# that reaches one of these is held by a port test of its own
REFERENCE_ONLY = frozenset({
    "jax", "jnp", "protocol", "engine", "encode", "decode", "synthetic",
    "lagrange", "ClusterRunner", "MPCClusterRunner", "MasterGroup",
    "CheckpointManager", "local_socket_cluster", "_sim_run", "_socket_run",
})


class _Missing:
    """Stands in for a reference object the port does not have: any use
    fails, so a case can never silently run the reference."""

    def __init__(self, what: str):
        self._what = what

    def __getattr__(self, name):
        raise AttributeError(f"{self._what} is not in the port")

    def __call__(self, *a, **kw):
        raise AttributeError(f"{self._what} is not in the port")


def _port_module_name(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


def _port_object(name: str, v):
    if isinstance(v, types.ModuleType):
        if v.__name__ == "repro" or v.__name__.startswith("repro."):
            try:
                return importlib.import_module(_port_module_name(v.__name__))
            except ImportError:
                return _Missing(v.__name__)
        return v
    if isinstance(v, (type, types.FunctionType)):
        mod, attr = v.__module__, v.__qualname__
    else:                         # an instance: the same global of the port
        mod, attr = type(v).__module__, name
    if not mod.startswith("repro."):
        return v
    try:
        return getattr(importlib.import_module(_port_module_name(mod)), attr)
    except (ImportError, AttributeError):
        return _Missing(f"{mod}.{attr}")


def _rebind(fn: types.FunctionType, g: dict) -> types.FunctionType:
    if hasattr(fn, "hypothesis"):
        # a property test: rebind the body, then re-apply its strategies and
        # settings (hypothesis keeps both on the wrapper)
        from hypothesis import given
        body = _rebind(fn.hypothesis.inner_test, g)
        return fn._hypothesis_internal_use_settings(
            given(**fn.hypothesis._given_kwargs)(body))
    new = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    return new


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``import`` inside a rebound function: the JAX package's modules
    resolve to the port's."""
    if level == 0 and (name == "repro" or name.startswith("repro.")):
        name = _port_module_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


@functools.lru_cache(maxsize=None)
def port_namespace(module_name: str) -> dict:
    """The reference test module's globals with the port swapped in."""
    module = importlib.import_module(module_name)
    g = {k: _port_object(k, v) for k, v in vars(module).items()}
    g["__builtins__"] = {**vars(builtins), "__import__": _port_import}
    for name, v in list(g.items()):
        if getattr(v, "__module__", None) != module_name:
            continue
        if isinstance(v, types.FunctionType):
            g[name] = _rebind(v, g)
        elif isinstance(v, type):
            g[name] = type(v.__name__, (v,), {
                k: _rebind(f, g) for k, f in vars(v).items()
                if isinstance(f, types.FunctionType)})
    return g


def _reached_names(module, fn) -> set[str]:
    """Names a function's source mentions, through the module's helpers."""
    tree = ast.parse(inspect.getsource(module))
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    seen, todo, names = set(), [fn.__name__], set()
    while todo:
        name = todo.pop()
        if name in seen or name not in defs:
            continue
        seen.add(name)
        for node in ast.walk(defs[name]):
            if isinstance(node, ast.Name):
                names.add(node.id)
                todo.append(node.id)
            elif isinstance(node, ast.arg):
                names.add(node.arg)
            elif isinstance(node, ast.alias):
                names.add((node.asname or node.name).split(".")[-1])
    return names


def _param_sets(fn) -> list[dict]:
    combos = [{}]
    for mark in reversed(getattr(fn, "pytestmark", [])):
        if mark.name != "parametrize":
            continue
        argnames, argvalues = mark.args[:2]
        if isinstance(argnames, str):
            argnames = [a.strip() for a in argnames.split(",")]
        rows = []
        for v in argvalues:
            v = getattr(v, "values", v)                 # pytest.param
            v = v if len(argnames) > 1 else (v,)
            rows.append(dict(zip(argnames, v)))
        combos = [{**a, **b} for a, b in itertools.product(combos, rows)]
    return combos


def reference_cases(module_name: str, exclude=(), properties: bool = False
                    ) -> list:
    """``pytest.param(module, test name, params)`` for every case of the
    module that reaches no ``REFERENCE_ONLY`` name (and is not named in
    ``exclude``); property tests (hypothesis) only with ``properties``."""
    module = importlib.import_module(module_name)
    out = []
    for name, fn in vars(module).items():
        if (not name.startswith("test_") or not isinstance(fn, types.FunctionType)
                or (hasattr(fn, "hypothesis") and not properties)
                or name in exclude
                or _reached_names(module, fn) & REFERENCE_ONLY):
            continue
        for i, params in enumerate(_param_sets(fn)):
            out.append(pytest.param(module_name, name, params,
                                    id=f"{module_name}::{name}[{i}]"))
    return out


def run_case(module_name: str, name: str, params: dict, request) -> None:
    """Run one case against the port; arguments that are not parameters
    are fixtures, resolved through ``request``."""
    fn = port_namespace(module_name)[name]
    kwargs = dict(params)
    if hasattr(fn, "hypothesis"):
        fn()                       # hypothesis draws every argument
        return
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = request.getfixturevalue(arg)
    fn(**kwargs)
