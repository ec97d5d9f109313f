"""The port's guard of its public surface, held to the JAX package's live one.

The twin of ``tests/test_arch_guard.py``: where that file pins the JAX
package's surface to snapshots, this one holds the port's live surfaces to
the JAX package's live ones, so a knob, a stats field or a public name that
one package grows and the other lacks fails here.  The port's own additions
are listed by name (``PORT_ONLY_*``), each with its reason; the
problem-generic core rule holds for ``src/repro_torch/core/``; and the
deprecated dict-style stats access behaves as JAX's does.
"""

import ast
import dataclasses
import pathlib
import warnings

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_CORE = ROOT / "src" / "repro_torch" / "core"

# the port's additions to the JAX surface, by design (ROADMAP section 3)
PORT_ONLY_API = {"resolve_device"}  # the CUDA-unless-asked device rule
PORT_ONLY_STATS = {"reduce_sweeps"}  # the fused kernel's reduction trip counts

FORBIDDEN = {
    "repro_torch.problems.vertex_cover",
    "repro_torch.problems.max_clique",
    "repro_torch.problems.mis",
}


def _fields(cls) -> dict:
    return {f.name: f for f in dataclasses.fields(cls)}


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return dataclasses.MISSING


def test_public_api_equals_jax_but_the_port_only_names():
    import repro.api as jax_api
    import repro_torch.api as api

    assert set(api.__all__) - PORT_ONLY_API == set(jax_api.__all__)
    assert PORT_ONLY_API <= set(api.__all__)
    for name in api.__all__:
        assert hasattr(api, name), f"repro_torch.api.__all__ lists missing {name!r}"


def test_backend_registry_equals_jax():
    from repro.api import known_backends as jax_backends
    from repro_torch.api import known_backends

    assert known_backends() == jax_backends()


def test_solve_config_fields_and_defaults_equal_jax():
    from repro.api import SolveConfig as JaxConfig
    from repro_torch.api import SolveConfig

    port, jax = _fields(SolveConfig), _fields(JaxConfig)
    assert sorted(port) == sorted(jax)
    for name in jax:
        assert _default(port[name]) == _default(jax[name]), name
    assert SolveConfig() == SolveConfig(**dataclasses.asdict(JaxConfig()))


@pytest.mark.parametrize("cls_name", ["SolveStats", "ServiceStats", "LaneStats"])
def test_stats_fields_equal_jax_but_the_port_only_counters(cls_name):
    import repro.api as jax_api
    import repro_torch.api as api

    port = set(_fields(getattr(api, cls_name)))
    jax = set(_fields(getattr(jax_api, cls_name)))
    assert port - PORT_ONLY_STATS == jax, cls_name


def test_default_problem_equals_jax_and_core_takes_it_from_the_registry():
    from repro.problems.registry import DEFAULT_PROBLEM as JAX_DEFAULT
    from repro_torch.core import engine
    from repro_torch.problems.registry import DEFAULT_PROBLEM, get_problem

    assert DEFAULT_PROBLEM == JAX_DEFAULT
    assert engine.DEFAULT_PROBLEM == DEFAULT_PROBLEM
    assert get_problem(DEFAULT_PROBLEM).name == DEFAULT_PROBLEM


def _imports_of(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_core_never_imports_a_concrete_problem():
    assert PORT_CORE.is_dir(), PORT_CORE
    offenders = {}
    for path in sorted(PORT_CORE.glob("*.py")):
        bad = [m for m in _imports_of(path)
               if m in FORBIDDEN or any(m.startswith(f + ".") for f in FORBIDDEN)]
        if bad:
            offenders[path.name] = bad
    assert not offenders, f"port core modules import concrete problem plugins: {offenders}"


def test_stats_dict_access_shim_warns_and_delegates():
    """The twin of JAX's test of the same name: dict-style access warns and
    delegates, ``to_dict()`` stays the warning-free export."""
    from repro_torch.api import SolveStats

    s = SolveStats(overflow_count=3)
    with pytest.warns(DeprecationWarning, match="dict-style access"):
        assert s["overflow_count"] == 3
    with pytest.warns(DeprecationWarning):
        assert "overflow" in s and s.get("missing", 7) == 7
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # attribute + to_dict never warn
        assert s.overflow_count == 3
        assert s.to_dict()["overflow_count"] == 3


@pytest.mark.parametrize("cls_name", ["SolveStats", "ServiceStats", "LaneStats"])
def test_dict_access_shim_matches_jax(cls_name):
    """Every verb of the shim gives what JAX's does on the shared fields,
    and each warns."""
    import repro.api as jax_api
    import repro_torch.api as api

    port, jax = getattr(api, cls_name)(), getattr(jax_api, cls_name)()
    shared = sorted(set(_fields(type(jax))))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for name in shared:
            assert port[name] == jax[name] and port.get(name) == jax.get(name)
            assert (name in port) and (name in jax)
        assert set(port.keys()) - PORT_ONLY_STATS == set(jax.keys())
        assert port.get("missing", 7) == jax.get("missing", 7) == 7
        with pytest.raises(KeyError):
            port["missing"]
    with pytest.warns(DeprecationWarning, match="dict-style access"):
        port.items()
    want = {k: v for k, v in jax.to_dict().items()}
    got = {k: v for k, v in port.to_dict().items() if k not in PORT_ONLY_STATS}
    assert got == want
