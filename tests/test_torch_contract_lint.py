"""The repo's contract linter (``tools/contract_lint``) over the PyTorch
port.

The checkers' scopes name the JAX package's directories: CL001 (ladder
discipline), CL004 (precision contract) and CL006 (counter registration)
match ``repro/serve/``, ``repro/core/`` and ``repro/kernels/``, which no
path under ``repro_torch/`` contains.  Here they are subclassed with the
port's scopes, and CL004 also learns torch's spellings of an f32 cast
(``.to(torch.float32)``, ``.float()``, ``dtype=torch.float32`` or
``dtype=np.float32`` in a conversion call).  They run with CL002
(integrity protocol) and CL003 (lock discipline), which already match by
file suffix and by annotation, over a project of ``src/repro_torch/``
alone: the registries (``LADDER_LAUNCH_SITES``, ``COUNTER_REGISTRY``)
are unions over the project, so the JAX package's must not stand in for
the port's.  The port must lint clean but for ``ALLOWED``, each entry an
exact cast with its reason; each rule has a case proving it sees a
violation under ``src/repro_torch/``.
"""

import ast
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tools.contract_lint.checkers import (  # noqa: E402
    CounterRegistrationChecker, IntegrityProtocolChecker,
    LadderDisciplineChecker, LockDisciplineChecker,
    PrecisionContractChecker)
from tools.contract_lint.engine import Project, dotted_name  # noqa: E402

PORT = REPO / "src" / "repro_torch"


class PortLadderChecker(LadderDisciplineChecker):
    SCOPE = ("repro_torch/serve/",)
    SCOPE_FILES = ("repro_torch/core/flow.py",)


class PortCounterChecker(CounterRegistrationChecker):
    SCOPE = ("repro_torch/serve/",)
    SCOPE_FILES = ("repro_torch/core/device_stats.py",)


class PortPrecisionChecker(PrecisionContractChecker):
    """CL004 with the port's scope and torch's spellings of the cast."""

    SCOPE = ("repro_torch/core/", "repro_torch/kernels/")
    F32 = PrecisionContractChecker.F32 + ("torch.float32", "torch.float")
    # calls that convert their first argument to the dtype they are given
    CONVERTERS = ("asarray", "array", "ascontiguousarray", "as_tensor",
                  "tensor")

    def _is_f32(self, node) -> bool:
        return dotted_name(node) in self.F32 or (
            isinstance(node, ast.Constant) and node.value == "float32")

    def _flag(self, node: ast.Call):
        hit = super()._flag(node)
        if hit is not None:
            return hit
        func = node.func
        dtype_kw = [k.value for k in node.keywords if k.arg == "dtype"]
        if isinstance(func, ast.Attribute):
            target = func.value
            # X.to(torch.float32) / X.to(dtype=...) / X.type(torch.float32)
            if func.attr in ("to", "type") and any(
                    self._is_f32(a) for a in list(node.args) + dtype_kw):
                return None if self._bool_expr(target) else \
                    f".{func.attr}(float32)"
            # X.float()
            if func.attr == "float" and not node.args \
                    and not self._bool_expr(target):
                return ".float()"
        # np.asarray(X, dtype=np.float32) / torch.as_tensor(X, dtype=...)
        name = (dotted_name(func) or "").split(".")[-1]
        if name in self.CONVERTERS and any(self._is_f32(d) for d in dtype_kw) \
                and node.args and not self._const_like(node.args[0]) \
                and not self._bool_expr(node.args[0]):
            return f"{name}(..., dtype=float32)"
        return None


CHECKERS = (PortLadderChecker(), IntegrityProtocolChecker(),
            LockDisciplineChecker(), PortPrecisionChecker(),
            PortCounterChecker())

# (rule, path, enclosing scope, source line) -> why the flagged cast is
# exact or outside the precision contract's domain
ALLOWED = {
    ("CL004", "src/repro_torch/kernels/ops.py", "keys_f32",
     "return np.asarray(keys, dtype=np.float32)"):
        "the JOIN key cast: round-to-nearest is monotone, so sorted keys "
        "stay sorted and a key inside a partition's f64 range stays inside "
        "its widened f32 interval (the partition side is widened)",
    ("CL004", "src/repro_torch/kernels/ops.py", "topk_boundary_device",
     "np.ascontiguousarray(rows, dtype=np.float32)).to(dev)"):
        "the rows are build_block_topk's f32 rows (widened when built): "
        "the cast is exact",
    ("CL004", "src/repro_torch/kernels/topk_boundary.py", "topk_boundary",
     "b32 = float(torch.tensor(float(b_init), dtype=torch.float32))"):
        "b_init is taken as the nearest f32 by contract; callers round it "
        "down first (ops.topk_boundary_device), so here it is exact",
    ("CL004", "src/repro_torch/kernels/ref.py", "flash_attention_ref",
     's = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (D ** -0.5)'):
        "attention activations in the LM's plain version, not metadata",
    ("CL004", "src/repro_torch/kernels/ref.py", "flash_attention_ref",
     'return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)'):
        "attention activations in the LM's plain version, not metadata",
    ("CL004", "src/repro_torch/kernels/ref.py", "flash_attention_bwd_ref",
     "qf, kf, vf, dof = (t[blk].float() for t in (q, k, v, do))"):
        "attention activations in the LM's plain version, not metadata",
}


def lint(sources):
    project = Project.from_sources(
        {p: textwrap.dedent(s) for p, s in sources.items()})
    return [f for c in CHECKERS for f in c.run(project)]


def port_sources():
    return {f"src/repro_torch/{p.relative_to(PORT).as_posix()}":
            p.read_text() for p in sorted(PORT.rglob("*.py"))}


def test_port_lints_clean():
    findings = lint(port_sources())
    keys = {(f.rule, f.path, f.context, f.snippet) for f in findings}
    unexplained = [f.render() for f in findings
                   if (f.rule, f.path, f.context, f.snippet) not in ALLOWED]
    assert not unexplained, "\n".join(unexplained)
    # every allowance still names a finding (none left over from an edit)
    assert set(ALLOWED) <= keys, set(ALLOWED) - keys


def test_port_registries_are_the_ports_own():
    """The project holds the port alone, so its registries are read from
    the port's modules."""
    project = Project.from_sources(port_sources())
    assert not any(m.path.startswith("src/repro/") for m in project.modules)
    from tools.contract_lint.engine import collect_registry
    sites = collect_registry(project, "LADDER_LAUNCH_SITES")
    assert {"PruningService._filter_rungs", "PruningService._verdict_group",
            "ServingFrontend._execute"} <= sites
    families = collect_registry(project, "PLANE_FAMILIES")
    assert {"tree_stat", "verdict"} <= families
    counters = collect_registry(project, "COUNTER_REGISTRY")
    assert {"tree_launches", "sharded_launches", "verdict_hits",
            "verdict_repairs", "latency", "p99_ms"} <= counters
    # the new modules are linted with the rest
    paths = {m.path for m in project.modules}
    assert {"src/repro_torch/serve/frontend.py",
            "src/repro_torch/launch/mesh.py"} <= paths


# ---------------------------------------------------------------------------
# one negative case per rule: the re-scoped checkers see a violation
# under src/repro_torch/
# ---------------------------------------------------------------------------

SERVICE = "src/repro_torch/serve/svc.py"
REGISTRY = {"src/repro_torch/serve/reg.py": """\
    LADDER_LAUNCH_SITES = frozenset({"Svc.rungs"})
    COUNTER_REGISTRY = frozenset({"retries", "filter"})
    """}


def rules(findings):
    return [f.rule for f in findings]


def test_cl001_flags_a_batched_call_outside_a_launch_site():
    src = """\
        class Svc:
            def rungs(self):
                return kops.prune_ranges_batched_tree([], None, None)

            def shortcut(self):
                return kops.prune_ranges_batched_device([], None)
        """
    findings = lint({SERVICE: src, **REGISTRY})
    assert rules(findings) == ["CL001"]
    assert findings[0].context == "Svc.shortcut"
    # the checker as shipped does not look under repro_torch/
    project = Project.from_sources({SERVICE: textwrap.dedent(src),
                                    **{k: textwrap.dedent(v)
                                       for k, v in REGISTRY.items()}})
    assert not LadderDisciplineChecker().run(project)


def test_cl002_flags_a_family_outside_the_registry():
    src = """\
        PLANE_FAMILIES = ("stat",)

        def plane_checksum(a):
            return 0

        class DeviceStatsCache:
            def __init__(self):
                self._stores = {"stat": {}, "tree_stat": {}}

            def get(self, t):
                self._admit("stat", t, 0)
                return plane_checksum(t)
        """
    findings = lint({"src/repro_torch/core/device_stats.py": src})
    assert rules(findings) == ["CL002"]
    assert "tree_stat" in findings[0].message


def test_cl003_flags_a_guarded_field_read_outside_the_lock():
    src = """\
        class Cache:
            def __init__(self):
                self.tree_planes = {}  # guarded-by: _lock

            def peek(self):
                return len(self.tree_planes)
        """
    assert rules(lint({"src/repro_torch/core/cache.py": src})) == ["CL003"]


@pytest.mark.parametrize("line,flagged", [
    ("y = x.astype(np.float32)", True),
    ("y = x.to(torch.float32)", True),
    ("y = x.to(dtype=torch.float32)", True),
    ("y = x.float()", True),
    ("y = torch.as_tensor(x, dtype=torch.float32)", True),
    ("y = np.asarray(x, dtype=np.float32)", True),
    ("y = torch.tensor(x, dtype=torch.float32)", True),
    # exact: a mask, a constant, an allocation, another dtype
    ("y = (x > 0).to(torch.float32)", False),
    ("y = (x > 0).float()", False),
    ("y = torch.full((3,), float('-inf'), dtype=torch.float32)", False),
    ("y = torch.as_tensor(1.0, dtype=torch.float32)", False),
    ("y = x.to(torch.int8)", False),
    ("y = round_down_f32(x)", False),
])
def test_cl004_sees_torch_spellings_of_the_cast(line, flagged):
    src = f"def cast(x):\n    {line}\n    return y\n"
    got = rules(lint({"src/repro_torch/core/cast.py": src}))
    assert got == (["CL004"] if flagged else [])
    # the checker as shipped sees none of them under repro_torch/
    project = Project.from_sources({"src/repro_torch/core/cast.py": src})
    assert not PrecisionContractChecker().run(project)


def test_cl006_flags_an_unregistered_counter_key():
    src = """\
        class Svc:
            def run(self):
                self.resilience["retries"] += 1
                self.resilience["tree_rescues"] += 1
                self.counters.bump("filter", launches=1)
        """
    findings = lint({SERVICE: src, **REGISTRY})
    assert rules(findings) == ["CL006"]
    assert "tree_rescues" in findings[0].message
