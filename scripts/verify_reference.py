#!/usr/bin/env python
"""SURVEY.md §9 re-verification hook.

Every load-bearing semantic of this rebuild is PINNED in ORACLE_SEMANTICS.md
because `/root/reference/` was EMPTY at survey time. This script is the
standing tripwire: run it any time (CI, round start); it

1. detects whether the reference mount is populated;
2. if EMPTY: prints a LOUD skip plus the full checklist of pins that are
   awaiting verification, and exits 0 (nothing to check against);
3. if POPULATED: walks the reference layout, imports the reference package,
   and diffs the NumPy oracle step-by-step against the real envs under an
   injected RNG stream (monkeypatching numpy's normal draws — SURVEY §7.4:
   seed-number equality across MT19937/threefry is impossible, stream
   injection is the exactness protocol), reporting VERIFIED / DIFFERS /
   UNCHECKED per pin, and exits 1 if anything DIFFERS.

Usage:
    python scripts/verify_reference.py [--reference /root/reference] [-v]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import traceback
from typing import Callable, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# ---------------------------------------------------------------- checklist
# Each pin: (key, ORACLE_SEMANTICS.md anchor, what must be checked against the
# reference). This is the §9 checklist in executable form — the empty-mount
# skip prints it so no pin is ever silently forgotten.
PINS: List[Tuple[str, str, str]] = [
    ("step_order", "§Step order",
     "harvest first, then growth (base_fishing_env.step calls harvest_draw "
     "then population_draw)"),
    ("noise_form", "§Step order item 4",
     "process noise enters as mu + sigma*x1*xi (additive, post-harvest stock)"
     " vs mu*exp(sigma*xi) (lognormal) — per growth model"),
    ("continuous_decode", "§Step order item 1",
     "fishing-v1 quota = (a+1)*K (action_scale=1.0) vs (a+1)/2*K"),
    ("relative_decode", "§Step order item 1",
     "3-action scheme multipliers [1.0, 1.2, 0.8] (maintain/+20%/-20%) and "
     "carried self.harvest state"),
    ("proportional_decode", "§Step order item 1",
     "n-action grid quota = a/n_actions * K"),
    ("reward_form", "§Step order item 6",
     "reward = price*harvest - cost*quota^2 (quadratic cost term; cost=0 "
     "default)"),
    ("termination", "§Step order item 7",
     "done = years_passed >= Tmax or stock <= 0; NO terminal penalty"),
    ("obs_scaling", "§Step order item 8",
     "obs = clip(x/K - 1, -1, 1); inverse x = K*(obs+1)"),
    ("obs_noise", "§Step order item 8",
     "measurement m = x*exp(sigma_m*eta) (lognormal), obs-noise variant only"),
    ("reset", "§State",
     "reset -> x=init_state (no random perturbation), harvest=init_harvest, "
     "t=0"),
    ("growth_logistic", "§Growth functions", "x + r*x*(1 - x/K)"),
    ("growth_ricker", "§Growth functions", "x*exp(r*(1 - x/K))"),
    ("growth_beverton_holt", "§Growth functions", "A*x / (1 + B*x)"),
    ("growth_allen", "§Growth functions", "x*exp(r*(1 - x/K)*(x - C)/K)"),
    ("growth_myers", "§Growth functions", "r*x^theta / (1 + x^theta/K)"),
    ("growth_may", "§Growth functions",
     "x + x*r*(1 - x/K) - a*x^q/(x^q + b^q); defaults r=0.75 K=1 a=0.175 "
     "b=0.1 q=2"),
    ("defaults", "§Shared pinned defaults",
     "K=1.0 r=0.3 price=1.0 sigma=0.05 init_state=0.75 Tmax=100 n_actions=3 "
     "init_harvest=0.0125 cost=0"),
    ("id_map", "registry/registry.py _register_all",
     "numbered id<->class map: v2=obs-error, v4=Allen, v5=BevertonHolt, "
     "v6=May, v7=Myers, v8=Ricker, v9=NonStationary, v10=ModelUncertainty; "
     "v3 absent"),
    ("rng_call_form", "§RNG protocol",
     "np.random.normal global RNG vs per-env default_rng; seeding via "
     "env.seed()/reset(seed=)"),
    ("collapse_penalty", "§Addenda",
     "no reward penalty on collapse in the reference (collapse_penalty=0)"),
]


@dataclasses.dataclass
class PinResult:
    key: str
    status: str  # VERIFIED | DIFFERS | UNCHECKED
    detail: str = ""


def reference_files(root: str) -> List[str]:
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in filenames:
            out.append(os.path.join(dirpath, f))
    return sorted(out)


# ----------------------------------------------------------- injected RNG
class _InjectedNormal:
    """Monkeypatch target for np.random.normal / Generator.normal: returns a
    recorded stream so the reference env becomes deterministic."""

    def __init__(self, stream):
        self.stream = list(stream)
        self.i = 0

    def __call__(self, loc=0.0, scale=1.0, size=None):
        import numpy as np

        n = 1 if size is None else int(np.prod(size))
        if self.i + n > len(self.stream):
            raise RuntimeError("injected RNG stream exhausted")
        vals = np.asarray(self.stream[self.i:self.i + n], dtype=float)
        self.i += n
        out = loc + scale * vals
        if size is None:
            return float(out[0])
        return out.reshape(size)


def _import_reference(root: str):
    """Import the reference gym_fishing package from the mount."""
    # package may live at root or one level down (e.g. root/gym_fishing-master)
    candidates = [root] + [
        os.path.join(root, d) for d in sorted(os.listdir(root))
        if os.path.isdir(os.path.join(root, d))
    ]
    for c in candidates:
        if os.path.isdir(os.path.join(c, "gym_fishing")):
            sys.path.insert(0, c)
            import gym_fishing  # noqa: F401

            return gym_fishing, c
    raise ImportError("no gym_fishing package found under the reference mount")


def _oracle_step_stream(env_id_cfg, x0, actions, xis):
    """Run our NumPy oracle with the injected stream; returns per-step
    (stock, reward, done)."""
    from gym_fishing_tpu.oracle import oracle as O

    cfg = O.OracleConfig(**env_id_cfg)
    state = O.reset(cfg)
    state = dataclasses.replace(state, stock=x0)
    rows = []
    for a, xi in zip(actions, xis):
        state, _obs, reward, done, _info = O.step_xi(cfg, state, a, xi, 0.0)
        rows.append((state.stock, reward, done))
        if done:
            state = O.reset(cfg)
    return rows


def _diff_continuous_env(ref_pkg_root: str, verbose: bool) -> List[PinResult]:
    """Step the reference fishing-v1 under injected RNG; diff vs the oracle.

    Returns results for the pins this exercise can decide. Any API surprise
    degrades to UNCHECKED with the traceback (never crashes the script).
    """
    import numpy as np

    results: List[PinResult] = []
    try:
        try:
            import gym
        except ImportError:
            import gymnasium as gym
        env = gym.make("fishing-v1")
        env = getattr(env, "unwrapped", env)

        K = float(getattr(env, "K", 1.0))
        r = float(getattr(env, "r", 0.3))
        sigma = float(getattr(env, "sigma", 0.05))
        init = float(getattr(env, "init_state", getattr(env, "fish_population", 0.75)))

        xis = list(np.linspace(-1.5, 1.5, 40))
        inj = _InjectedNormal(xis)
        saved = np.random.normal
        np.random.normal = inj
        try:
            try:
                obs = env.reset(seed=0)
            except TypeError:
                obs = env.reset()
            ref_rows = []
            for t in range(20):
                a = np.asarray([np.sin(t * 0.7)], dtype=np.float32)  # varied
                out = env.step(a)
                if len(out) == 5:
                    obs, rew, term, trunc, info = out
                    done = term or trunc
                else:
                    obs, rew, done, info = out
                stock = float(
                    info.get("fish_population", K * (np.asarray(obs).ravel()[0] + 1))
                ) if isinstance(info, dict) else K * (np.asarray(obs).ravel()[0] + 1)
                ref_rows.append((stock, float(rew), bool(done)))
                if done:
                    break
        finally:
            np.random.normal = saved
        used = inj.i

        # oracle replay with BOTH pinned decode constants; see which matches
        for decode_scale, pin_note in ((1.0, "(a+1)*K"), (0.5, "(a+1)/2*K")):
            orc_rows = _oracle_step_stream(
                dict(growth="logistic", noise_form="additive", scheme="continuous",
                     K=K, r=r, sigma=sigma, init_state=init,
                     action_scale=decode_scale),
                init,
                [np.sin(t * 0.7) for t in range(len(ref_rows))],
                xis[:used] + [0.0] * max(0, len(ref_rows) - used),
            )
            ok = all(
                abs(a[0] - b[0]) < 1e-9 and abs(a[1] - b[1]) < 1e-9
                for a, b in zip(ref_rows, orc_rows)
            )
            if ok:
                results.append(PinResult(
                    "continuous_decode", "VERIFIED",
                    f"quota = {pin_note} reproduces the reference stream"))
                results.append(PinResult(
                    "noise_form", "VERIFIED", "additive form matched stepwise"))
                results.append(PinResult(
                    "step_order", "VERIFIED", "stepwise trajectory match"))
                break
        else:
            results.append(PinResult(
                "continuous_decode", "DIFFERS",
                f"neither pinned decode reproduces the reference; ref rows: "
                f"{ref_rows[:3]}..."))
    except Exception:
        results.append(PinResult(
            "continuous_decode", "UNCHECKED",
            traceback.format_exc(limit=3) if verbose else
            "reference API did not match the expected surface; run with -v"))
    return results


def _check_id_map(verbose: bool) -> PinResult:
    try:
        try:
            import gym
            registry = gym.envs.registry
        except ImportError:
            import gymnasium as gym
            registry = gym.registry
        ids = sorted(
            k for k in (registry.keys() if hasattr(registry, "keys")
                        else [s.id for s in registry.all()])
            if "fishing" in k
        )
        return PinResult("id_map", "UNCHECKED",
                         f"reference registers: {ids} — diff manually against "
                         "registry/registry.py numbered-alias map")
    except Exception:
        return PinResult("id_map", "UNCHECKED",
                         traceback.format_exc(limit=2) if verbose else
                         "could not read the gym registry")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default="/root/reference")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()

    files = (
        reference_files(args.reference) if os.path.isdir(args.reference) else []
    )
    if not files:
        print("=" * 72)
        print("VERIFY_REFERENCE: SKIP — reference mount is EMPTY "
              f"({args.reference}: 0 files)")
        print("Every semantic below remains PINNED-NOT-VERIFIED "
              "(ORACLE_SEMANTICS.md). Re-run this script when the mount "
              "populates; it will diff the oracle against the real envs.")
        print("=" * 72)
        for key, anchor, what in PINS:
            print(f"  [PINNED] {key:24s} {anchor:28s} {what}")
        print(f"\n{len(PINS)} pins awaiting verification. Exit 0 (nothing to "
              "check against).")
        return 0

    print(f"VERIFY_REFERENCE: reference mount POPULATED ({len(files)} files)")
    print("§9.1 layout:")
    for f in files[:200]:
        print("  ", os.path.relpath(f, args.reference))

    results: List[PinResult] = []
    try:
        _pkg, pkg_root = _import_reference(args.reference)
        print(f"imported reference package from {pkg_root}")
        results += _diff_continuous_env(pkg_root, args.verbose)
        results.append(_check_id_map(args.verbose))
    except Exception:
        print("could not import the reference package:")
        traceback.print_exc(limit=3)

    decided = {r.key: r for r in results}
    print("\n§9.2-9.3 pin status:")
    n_diff = 0
    for key, anchor, _what in PINS:
        r = decided.get(key, PinResult(key, "UNCHECKED",
                                       "no automated probe yet — check by hand"))
        n_diff += r.status == "DIFFERS"
        print(f"  [{r.status:9s}] {key:24s} {r.detail[:100]}")
    print(f"\n{n_diff} pins DIFFER. "
          + ("FIX ORACLE_SEMANTICS.md + oracle + engine in lockstep."
             if n_diff else "No verified differences."))
    return 1 if n_diff else 0


if __name__ == "__main__":
    sys.exit(main())
