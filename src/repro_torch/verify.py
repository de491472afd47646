"""Standalone plan verification CLI + fuzz harness.

Single plan (explicit geometry)::

    PYTHONPATH=src python -m repro_torch.verify \\
        --seqlens 7000,500,300,4000,2000,2584 --workers 4 \\
        --block-size 128 --coalesce 4 --mask swa:1024 --wire int8

Fuzz harness (random compositions x masks x knob grids, seeded)::

    PYTHONPATH=src python -m repro_torch.verify --fuzz --plans 200 --seed 0

Every generated plan runs the full static invariant catalogue
(:mod:`repro_torch.analysis.verifier`) *and* the spec/plan-key consistency
check against the :func:`repro_torch.core.plan_cache.plan_key` the same knobs
produce.  Exit status is the number of plans with violations (capped at
the usual 0/1 shell semantics via nonzero = failure).  Pure host code:
numpy only, no devices, safe as a CI job.
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

import numpy as np

from .analysis import verifier
from .core import plan_cache as pc
from .core.schedule import make_schedule

# fuzz grids: planner knobs the harness draws from.  Deliberately wide
# — the point is to hit coalescer windows, identity fallbacks, padded
# tails and byte-repriced wires the curated tests don't enumerate.
_WORKERS = (2, 3, 4, 6, 8)
_BLOCK_SIZES = (8, 16, 32)
_MASKS = ("causal", "full", "swa:{w}", "chunked:{c}")
_COALESCE = (1, 2, 3, 4, 8, 16)
_WIRES = ("f32", "bf16", "int8")
_IN_BYTES = (4.0, 2.0)
_LOCALITY = ("auto", True, False)
_OVERLAP = (False, True)


def _random_seqlens(rng: np.random.Generator, budget: int,
                    block_size: int) -> list[int]:
    """A random composition of <= ``budget`` tokens: a few long docs
    plus a short-doc tail (sub-block lengths included — padding paths
    must verify too)."""
    lens: list[int] = []
    rest = budget
    while rest > 0:
        if rng.random() < 0.3 and rest >= 4 * block_size:
            lo, hi = 2 * block_size, max(rest // 2, 2 * block_size + 1)
            ln = int(rng.integers(lo, hi))
        else:
            ln = int(rng.integers(1, min(rest, 2 * block_size) + 1))
        lens.append(min(ln, rest))
        rest -= lens[-1]
        if len(lens) > 64:                   # keep the planner fast
            lens.append(rest)
            rest = 0
    return [x for x in lens if x > 0]


def _random_case(rng: np.random.Generator) -> dict:
    n_workers = int(rng.choice(_WORKERS))
    block_size = int(rng.choice(_BLOCK_SIZES))
    slots = int(rng.integers(2, 9))
    tpw = slots * block_size
    seqlens = _random_seqlens(rng, n_workers * tpw, block_size)
    if rng.random() < 0.25:                  # bucketed (cache-canonical)
        seqlens = list(pc.canonicalize_lengths(
            seqlens, n_workers * tpw, block_size))
    mask = str(rng.choice(_MASKS)).format(
        w=int(rng.choice((1, 2, 4, 16))) * block_size,
        c=int(rng.choice((1, 2, 8))) * block_size)
    speeds = None
    if rng.random() < 0.3:
        speeds = tuple(float(s) for s in
                       rng.uniform(0.5, 1.5, size=n_workers))
    return dict(
        seqlens=seqlens, n_workers=n_workers, tokens_per_worker=tpw,
        block_size=block_size, mask=mask,
        coalesce=int(rng.choice(_COALESCE)),
        wire=str(rng.choice(_WIRES)),
        in_dtype_bytes=float(rng.choice(_IN_BYTES)),
        locality=_LOCALITY[int(rng.integers(len(_LOCALITY)))],
        overlap=bool(rng.choice(_OVERLAP)),
        speeds=speeds,
        n_q_heads=int(rng.choice((1, 2, 8))),
        n_kv_heads=1, head_dim=int(rng.choice((32, 64, 128))))


def verify_case(case: dict) -> list:
    """Build the plan for ``case`` and return its violations (both the
    invariant catalogue and spec/plan-key consistency)."""
    case = dict(case)
    nh = case.pop("n_q_heads", 8)
    nkv = case.pop("n_kv_heads", 8)
    nkv = min(nkv, nh)
    hd = case.pop("head_dim", 128)
    sched = make_schedule(
        case["seqlens"], case["n_workers"], case["tokens_per_worker"],
        case["block_size"], n_q_heads=nh, n_kv_heads=nkv, head_dim=hd,
        mask=case["mask"], coalesce=case["coalesce"], wire=case["wire"],
        in_dtype_bytes=case["in_dtype_bytes"],
        locality=case["locality"], overlap=case.get("overlap", False),
        speeds=case["speeds"],
        verify=False)                        # the harness IS the verifier
    key = pc.plan_key(
        case["seqlens"], case["n_workers"], case["tokens_per_worker"],
        case["block_size"], mask=case["mask"], coalesce=case["coalesce"],
        wire=case["wire"], in_dtype_bytes=case["in_dtype_bytes"],
        locality=case["locality"], overlap=case.get("overlap", False),
        speeds=case["speeds"],
        extra=(nh, nkv, hd))
    return verifier.verify_schedule(
        sched, n_q_heads=nh, n_kv_heads=nkv, head_dim=hd,
        in_dtype_bytes=case["in_dtype_bytes"], key=key)


def _describe(case: dict) -> str:
    return (f"workers={case['n_workers']} bs={case['block_size']} "
            f"tpw={case['tokens_per_worker']} mask={case['mask']} "
            f"coalesce={case['coalesce']} wire={case['wire']} "
            f"inb={case['in_dtype_bytes']} loc={case['locality']} "
            f"ov={int(case.get('overlap', False))} "
            f"ndocs={len(case['seqlens'])}")


def fuzz(n_plans: int, seed: int, verbose: bool = False) -> int:
    """Verify ``n_plans`` random plans; returns the number that had
    violations (0 == clean run)."""
    rng = np.random.default_rng(seed)
    bad = 0
    for i in range(n_plans):
        case = _random_case(rng)
        try:
            violations = verify_case(case)
        except Exception as e:              # planner refusals are fine;
            if isinstance(e, verifier.PlanVerificationError):
                raise                       # verifier errors are not
            if verbose:
                print(f"[{i}] planner rejected ({e}): "
                      f"{_describe(case)}")
            continue
        if violations:
            bad += 1
            print(f"[{i}] {len(violations)} violation(s): "
                  f"{_describe(case)}", file=sys.stderr)
            print(f"      seqlens={case['seqlens']}", file=sys.stderr)
            for viol in violations[:10]:
                print(f"      {viol}", file=sys.stderr)
        elif verbose:
            print(f"[{i}] ok: {_describe(case)}")
    return bad


def fuzz_elastic(n_cases: int, seed: int, verbose: bool = False) -> int:
    """Survivor-set replan sweep (the recovery path of
    :mod:`repro_torch.runtime.elastic` + :mod:`repro_torch.launch.train`'s
    supervised loop): for each random case, build the base plan through
    a live cache, kill each worker id in turn and verify the replanned
    schedule on the survivors, then regrow to the original fleet and
    assert the cache re-hits the pre-shrink plan *object*.  Each case
    then replays as a multi-pod fleet: whole *pods* die down the
    divisor chain (every surviving pod adopts the lost pods'
    sub-streams via ``pods=/base_pods=``), each survivor schedule
    verifies, and the pod regrow must re-hit the pre-shrink plan too.
    Returns the number of cases with violations (0 == clean run)."""
    from .runtime import elastic

    rng = np.random.default_rng(seed)
    bad = 0
    for i in range(n_cases):
        case = _random_case(rng)
        n = case["n_workers"]
        nh, nkv = case["n_q_heads"], min(case["n_kv_heads"],
                                         case["n_q_heads"])
        hd = case["head_dim"]
        cache = pc.PlanCache(max_size=64, verify=False)

        def rp(nw, sp, pods=1, base_pods=None, _c=case, _cache=cache,
               _nh=nh, _nkv=nkv, _hd=hd):
            return elastic.replan(
                _c["seqlens"], nw, _c["block_size"], n_q_heads=_nh,
                n_kv_heads=_nkv, head_dim=_hd, mask=_c["mask"],
                coalesce=_c["coalesce"], wire=_c["wire"],
                in_dtype_bytes=_c["in_dtype_bytes"],
                overlap=_c.get("overlap", False), speeds=_sp(sp),
                cache=_cache, verify=False, pods=pods,
                base_pods=base_pods)

        def _sp(sp):
            return None if sp is None else np.asarray(sp)

        try:
            base = rp(n, case["speeds"])
        except Exception as e:
            if isinstance(e, verifier.PlanVerificationError):
                raise
            if verbose:
                print(f"[{i}] planner rejected ({e}): {_describe(case)}")
            continue
        violations: list = []
        for k in range(n):
            surv = (None if case["speeds"] is None else
                    tuple(s for j, s in enumerate(case["speeds"])
                          if j != k))
            try:
                sched = rp(n - 1, surv)
            except Exception as e:
                if isinstance(e, verifier.PlanVerificationError):
                    raise
                continue                    # planner refusal is fine
            key = elastic.replan_key(
                case["seqlens"], n - 1, case["block_size"],
                mask=case["mask"], coalesce=case["coalesce"],
                wire=case["wire"],
                in_dtype_bytes=case["in_dtype_bytes"],
                overlap=case.get("overlap", False), speeds=surv)
            violations += verifier.verify_schedule(
                sched, n_q_heads=nh, n_kv_heads=nkv, head_dim=hd,
                in_dtype_bytes=case["in_dtype_bytes"], key=key)
        regrown = rp(n, case["speeds"])
        if regrown is not base:
            violations.append(
                f"regrow to {n} workers missed the plan cache "
                f"(pre-shrink plan was evicted or re-keyed)")
        # pod-scoped kills: the same composition viewed as a pods0-pod
        # fleet (the pinned loader repeats it per pod).  Walk the
        # divisor chain down — each shrink hands every surviving pod
        # the lost pods' sub-streams — and verify every survivor
        # schedule; then regrow, which at full strength reduces to the
        # plain key and must re-hit the pre-shrink plan object.
        tokens = sum(case["seqlens"])
        pods0 = 4 if (tokens * 4 <= 4096 and int(rng.integers(2))) else 2
        p = pods0 // 2
        while p >= 1:
            surv_sp = case["speeds"]
            try:
                sched = rp(n, surv_sp, pods=p, base_pods=pods0)
            except Exception as e:
                if isinstance(e, verifier.PlanVerificationError):
                    raise
                if verbose:
                    print(f"[{i}] planner rejected pod fleet "
                          f"{p}/{pods0} ({e}): {_describe(case)}")
                break                       # planner refusal is fine
            key = elastic.replan_key(
                case["seqlens"], n, case["block_size"],
                mask=case["mask"], coalesce=case["coalesce"],
                wire=case["wire"],
                in_dtype_bytes=case["in_dtype_bytes"],
                overlap=case.get("overlap", False), speeds=surv_sp,
                pods=p, base_pods=pods0)
            violations += verifier.verify_schedule(
                sched, n_q_heads=nh, n_kv_heads=nkv, head_dim=hd,
                in_dtype_bytes=case["in_dtype_bytes"], key=key)
            p //= 2
        pod_regrown = rp(n, case["speeds"], pods=pods0, base_pods=pods0)
        if pod_regrown is not base:
            violations.append(
                f"pod regrow to {pods0} pods missed the plan cache "
                f"(full-strength key must equal the pre-shrink key)")
        if violations:
            bad += 1
            print(f"[{i}] {len(violations)} violation(s): "
                  f"{_describe(case)}", file=sys.stderr)
            print(f"      seqlens={case['seqlens']}", file=sys.stderr)
            for viol in violations[:10]:
                print(f"      {viol}", file=sys.stderr)
        elif verbose:
            print(f"[{i}] ok ({n} worker kills + pod chain "
                  f"{pods0}->1 + regrows): {_describe(case)}")
    return bad


def _parse_lens(text: str) -> list[int]:
    return [int(x) for x in text.replace(",", " ").split()]


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fuzz", action="store_true",
                    help="fuzz random plans instead of one explicit plan")
    ap.add_argument("--fuzz-elastic", action="store_true",
                    help="fuzz survivor-set replans: kill each worker"
                         " in turn, then whole pods down the divisor"
                         " chain, verify every survivor schedule, and"
                         " assert plan-cache re-hit on both regrows")
    ap.add_argument("--plans", type=int, default=200,
                    help="number of fuzz plans (default 200)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--seqlens", type=_parse_lens, default=None,
                    help="comma-separated document lengths")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--tokens-per-worker", type=int, default=None,
                    help="default: ceil(sum(seqlens)/workers) blocks")
    ap.add_argument("--mask", default="causal")
    ap.add_argument("--coalesce", type=int, default=1)
    ap.add_argument("--wire", default="f32")
    ap.add_argument("--in-dtype-bytes", type=float, default=4.0)
    ap.add_argument("--locality", default="auto")
    ap.add_argument("--overlap", action="store_true",
                    help="verify the double-buffered (software-"
                         "pipelined) variant of the plan")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=128)
    args = ap.parse_args(argv)

    if args.fuzz_elastic:
        bad = fuzz_elastic(args.plans, args.seed, verbose=args.verbose)
        if bad:
            print(f"FAIL: {bad}/{args.plans} elastic cases violated "
                  f"invariants", file=sys.stderr)
            return 1
        print(f"ok: {args.plans} survivor-set replan sweeps verified "
              f"(worker + pod kills, seed {args.seed}), 0 violations")
        return 0

    if args.fuzz:
        bad = fuzz(args.plans, args.seed, verbose=args.verbose)
        if bad:
            print(f"FAIL: {bad}/{args.plans} plans violated invariants",
                  file=sys.stderr)
            return 1
        print(f"ok: {args.plans} random plans verified "
              f"(seed {args.seed}), 0 violations")
        return 0

    if args.seqlens is None:
        ap.error("--seqlens is required without --fuzz")
    bs = args.block_size
    tpw = args.tokens_per_worker
    if tpw is None:
        tpw = -(-sum(args.seqlens) // (args.workers * bs)) * bs
    loc = {"auto": "auto", "on": True, "off": False,
           "true": True, "false": False}.get(
        str(args.locality).lower(), args.locality)
    case = dict(
        seqlens=args.seqlens, n_workers=args.workers,
        tokens_per_worker=tpw, block_size=bs, mask=args.mask,
        coalesce=args.coalesce, wire=args.wire,
        in_dtype_bytes=args.in_dtype_bytes, locality=loc,
        overlap=args.overlap, speeds=None,
        n_q_heads=args.heads, n_kv_heads=args.kv_heads,
        head_dim=args.head_dim)
    violations = verify_case(case)
    if violations:
        print(f"{len(violations)} violation(s):", file=sys.stderr)
        for viol in violations:
            print(f"  {viol}", file=sys.stderr)
        return 1
    print(f"ok: plan verified ({_describe(case)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
