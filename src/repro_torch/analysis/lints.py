"""Repo-specific static lints of the port (``python -m
repro_torch.analysis.lints``; the reference's :mod:`repro.analysis.lints`
recast for PyTorch on stacked workers).

* **spec/key reflection lint** — every field of ``StaticSpec`` must be
  accounted for in :func:`repro_torch.core.plan_cache.plan_key`: a direct
  key input, derived deterministically from the key inputs, or a planner
  knob with a registered probe proving two values of the knob produce
  different keys (the reference's registry, over the port's copies of
  ``StaticSpec`` and ``plan_key``).
* **static-argument lint** — every type that keys the plan cache or the
  memoized executor tables (``ExecConfig``, ``StaticSpec`` and its
  members, ``MaskSpec``, ``WireFormat``, ``Ranks``: ``schedule_tables``
  and the train loops' step caches look them up) must be a frozen
  dataclass and hashable, or a lookup dies (or misses) in whatever path
  first passes one.
* **ship-bypass lint** — cross-worker data moves only through
  ``runtime/wire.py``: no other module touches its private ``_ship`` /
  ``_Ship`` (which skip the wire format's codec and its differentiable
  backward), and no other module calls a ``torch.distributed``
  point-to-point or collective op.  ``core/executor.pod_perm`` only
  offsets a ship's pairs and stays legal.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import sys
from typing import Callable, Iterable

_SRC = pathlib.Path(__file__).resolve().parents[2]

# the one module allowed to move data between workers (relative to src/)
_WIRE_HOME = pathlib.Path("repro_torch/runtime/wire.py")
_PRIVATE_SHIP = frozenset({"_ship", "_Ship"})
# torch.distributed ops that move data between ranks (names, or prefixes
# ending in "*")
_DIST_OPS = ("send", "recv", "isend", "irecv", "batch_isend_irecv",
             "all_to_all*", "all_gather*", "all_reduce", "reduce_scatter*")


# --------------------------------------------------------------------------
# spec/key reflection lint
# --------------------------------------------------------------------------

# StaticSpec fields that ARE plan_key inputs directly (or trivially
# recoded: slots == tokens_per_worker / block_size)
DIRECT_FIELDS = frozenset({"n_workers", "block_size", "slots"})

# fields the planner derives deterministically from the key inputs —
# two builds under equal keys produce equal values, so they need no key
# entry of their own
DERIVED_FIELDS = frozenset({
    "ext_slots", "n_matchings", "n_rounds", "n_steps", "n_resh_rounds",
    "comm_rounds", "resh_rounds", "run_starts",
})

# planner knobs: StaticSpec fields (and key-only knobs) that must each
# provably change plan_key.  Each probe is (label, kwargs_a, kwargs_b);
# the lint asserts plan_key(**a) != plan_key(**b).
KNOB_PROBES: dict[str, list[tuple[str, dict, dict]]] = {
    "mask": [
        ("mask family", {"mask": "causal"}, {"mask": "full"}),
        ("mask window identity", {"mask": "swa:16"}, {"mask": "swa:32"}),
        ("mask chunk identity",
         {"mask": "chunked:16"}, {"mask": "chunked:32"}),
    ],
    "wire": [
        ("wire format", {"wire": "f32"}, {"wire": "int8"}),
        ("compute itemsize repricing",
         {"in_dtype_bytes": 4.0}, {"in_dtype_bytes": 2.0}),
    ],
    "coalesce": [
        ("coalescer degree", {"coalesce": 1}, {"coalesce": 2}),
    ],
    "overlap": [
        ("double-buffered-rounds parity bit",
         {"overlap": False}, {"overlap": True}),
    ],
}

# key-only knobs (not StaticSpec fields) that still must differ-key —
# they steer the distributor, so equal keys must mean equal plans
EXTRA_PROBES: list[tuple[str, dict, dict]] = [
    ("locality", {"locality": "auto"}, {"locality": False}),
    ("alpha", {"alpha": 1.0}, {"alpha": 2.0}),
    ("beta", {"beta": 1.0}, {"beta": 2.0}),
    ("speeds", {"speeds": None}, {"speeds": (1.0, 0.5)}),
    ("extra (caller context)", {"extra": ()}, {"extra": (8,)}),
]


def check_spec_key_coverage(
        extra_fields: Iterable[str] = ()) -> list[str]:
    """Reflect over ``StaticSpec`` and prove every field is folded into
    ``plan_key``.  ``extra_fields`` injects a hypothetical new field (the
    lint's own tests watch it fail)."""
    from ..core import plan_cache as pc
    from ..core.schedule import StaticSpec

    errors: list[str] = []
    names = [f.name for f in dataclasses.fields(StaticSpec)]
    names += list(extra_fields)
    for name in names:
        if name in DIRECT_FIELDS or name in DERIVED_FIELDS:
            continue
        if name not in KNOB_PROBES:
            errors.append(
                f"StaticSpec.{name} has no plan_key accounting: fold it "
                f"into core/plan_cache.plan_key and register it in "
                f"analysis/lints.py (KNOB_PROBES with a differing-key "
                f"probe, or DERIVED_FIELDS if the key inputs determine "
                f"it)")

    def key(**kw) -> tuple:
        base = dict(mask=True, coalesce=1, locality="auto", alpha=1.0,
                    beta=1.0, speeds=None, wire="f32",
                    in_dtype_bytes=4.0, overlap=False, extra=())
        base.update(kw)
        return pc.plan_key([64, 32], 2, 64, 32, **base)

    probes = [p for plist in KNOB_PROBES.values() for p in plist]
    for label, kw_a, kw_b in probes + EXTRA_PROBES:
        if key(**kw_a) == key(**kw_b):
            errors.append(
                f"plan_key does not distinguish {label}: {kw_a} and "
                f"{kw_b} collide — cached plans would cross knobs")
    return errors


# --------------------------------------------------------------------------
# static-argument lint
# --------------------------------------------------------------------------

def static_arg_samples() -> list[tuple[type, Callable[[], object]]]:
    """The types that key the plan cache and the memoized tables, each
    with a way to build one."""
    from ..core.executor import ExecConfig
    from ..core.schedule import CommGroup, CommRound, StaticSpec
    from ..masks import MaskSpec
    from ..runtime.wire import Ranks, WireFormat

    group = CommGroup(perm=((0, 1),), rows=1)
    return [
        (MaskSpec, MaskSpec),
        (WireFormat, WireFormat),
        (ExecConfig, ExecConfig),
        (Ranks, lambda: Ranks(2, 1, "gloo")),
        (CommGroup, lambda: group),
        (CommRound, lambda: CommRound(groups=(group,))),
        (StaticSpec, lambda: StaticSpec(
            n_workers=2, block_size=32, slots=1, ext_slots=0, coalesce=1,
            n_matchings=0, n_rounds=0, n_steps=0, n_resh_rounds=0,
            comm_rounds=(), resh_rounds=(), mask=MaskSpec())),
    ]


def check_static_args(
        samples: Iterable[tuple[type, Callable[[], object]]] | None = None
) -> list[str]:
    """Types that key the plan cache and the memoized tables must be
    frozen dataclasses and hashable in practice."""
    errors: list[str] = []
    for cls, make in (static_arg_samples() if samples is None
                      else samples):
        if not dataclasses.is_dataclass(cls):
            errors.append(f"{cls.__name__} is not a dataclass")
            continue
        if not cls.__dataclass_params__.frozen:  # type: ignore[attr-defined]
            errors.append(
                f"{cls.__name__} must be frozen=True: it is used in "
                f"plan-cache and memo keys")
        try:
            hash(make())
        except TypeError as e:
            errors.append(f"{cls.__name__} is not hashable (plan-cache "
                          f"and memo keys): {e}")
    return errors


# --------------------------------------------------------------------------
# ship-bypass lint
# --------------------------------------------------------------------------

def _is_dist_op(name: str) -> bool:
    return any(name.startswith(op[:-1]) if op.endswith("*") else name == op
               for op in _DIST_OPS)


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` of a Name / Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def ship_bypasses(tree: ast.AST) -> list[tuple[int, str]]:
    """(line, what) of every use of the wire's private ship and every
    call of a ``torch.distributed`` data-moving op in a module."""
    dist_mods = {"torch.distributed"}      # names bound to the module
    dist_fns: dict[str, str] = {}          # local name -> op name
    found: list[tuple[int, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    dist_mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    dist_mods.add(a.asname or a.name)
                elif (node.module or "").startswith("torch.distributed") \
                        and _is_dist_op(a.name):
                    dist_fns[a.asname or a.name] = a.name
                if a.name in _PRIVATE_SHIP:
                    found.append((node.lineno, f"imports wire.{a.name}"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in _PRIVATE_SHIP:
            found.append((node.lineno, f"uses wire.{node.attr}"))
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in dist_fns:
            found.append((node.lineno,
                          f"calls torch.distributed.{dist_fns[fn.id]}"))
        elif isinstance(fn, ast.Attribute) and _is_dist_op(fn.attr) \
                and _dotted(fn.value) in dist_mods:
            found.append((node.lineno,
                          f"calls torch.distributed.{fn.attr}"))
    return sorted(found)


def check_ship_sites(root: pathlib.Path = _SRC) -> list[str]:
    """Every cross-worker move outside ``runtime/wire.py`` is an error:
    all shipping goes through ``wire.ship``."""
    errors: list[str] = []
    for path in sorted((root / "repro_torch").rglob("*.py")):
        rel = path.relative_to(root)
        if rel == _WIRE_HOME:
            continue
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            errors.append(f"{rel}: unparseable ({e})")
            continue
        for line, what in ship_bypasses(tree):
            errors.append(
                f"{rel}:{line}: {what}, bypassing wire.ship (wire "
                f"formats, byte accounting and the differentiable, "
                f"quantization-aware backward)")
    return errors


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------

def run_all(extra_spec_fields: Iterable[str] = ()) -> list[str]:
    errors = []
    errors += check_spec_key_coverage(extra_spec_fields)
    errors += check_static_args()
    errors += check_ship_sites()
    return errors


def main(argv: list[str] | None = None) -> int:
    del argv
    errors = run_all()
    if errors:
        print(f"{len(errors)} lint error(s):", file=sys.stderr)
        for e in errors:
            print(f"  {e}", file=sys.stderr)
        return 1
    print("repro_torch lints: OK (spec/key coverage, static args, ship "
          "sites)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
