#!/usr/bin/env python
"""Run the engine, the PPO learner and the DP solver once on a GPU and check them.

    python chip_smoke.py               # one card: engine, PPO, DP
    python chip_smoke.py --multichip   # four cards: the sharded PPO learner only

Each phase runs through the entry points users call and is compared with a
plain reference at a stated tolerance and precision:

1. engine — fishing-v1 under the escapement policy at B=2^21, T=512 in
   float32 (finite, env-steps/s, memory analysis); then the same program on
   4,096 rows in float64 on the card, fishing-v1 and the May tipping-point
   env, against the NumPy float64 oracle fed the program's own noise draws.
2. PPO — BASELINE config 5 (16,384 envs x 128 steps, 4 epochs x 8
   minibatches, hidden 64): one ``train_step`` at "highest" precision on the
   card against the same jitted function on the CPU, three iterations of
   ``agents.ppo.train``, the gap at default precision, and the time of the
   iteration split into rollout, GAE + packing and the minibatch epochs.
3. DP — ``value_iteration`` at examples/dp_optimal.py's default grid against
   a NumPy float64 value iteration on the same MDP.
4. ``--multichip`` — GSPMD ``train_step`` over a 1-D mesh of four cards at
   16,384 envs per card against the same 65,536 envs on one card.

Any failure exits non-zero. The last line of standard output is the only
JSON result: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
Without a GPU the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from functools import partial

OPTIONAL_PACKAGES = ("flax", "pandas", "matplotlib", "gymnasium", "orbax")

# tests/test_exactness.py's tolerance: float64 engine vs float64 oracle
ORACLE_ATOL = 1e-12
# PPO, card vs CPU at "highest": see check_ppo_reference
PPO_STATE_ATOL = 1e-6
PPO_PARAMS_ATOL = 2e-5
PPO_LOSS_RTOL = 1.5e-5
# DP, float32 value iteration vs float64: see phase_dp
DP_V_ATOL = 2e-3


def log(*parts) -> None:
    print(*parts, flush=True)


def optional_packages() -> dict:
    """Which optional packages this interpreter can import."""
    return {name: importlib.util.find_spec(name) is not None
            for name in OPTIONAL_PACKAGES}


def _timed(fn, *args, reps: int = 3):
    """(mean seconds per call after one warm-up, last output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps, out


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: getattr(m, k, None) for k in keys} if m is not None else {}


# ---------------------------------------------------------------- engine
def oracle_config(env, params):
    """The NumPy oracle's config for an engine (env, params) pair."""
    import numpy as np

    from gym_fishing_tpu.oracle import OracleConfig

    kw = {f.name: getattr(env.config, f.name)
          for f in dataclasses.fields(env.config)}
    for f in dataclasses.fields(params):
        kw[f.name] = np.asarray(getattr(params, f.name)).item()
    return OracleConfig(**kw)


def oracle_rollout(cfg, actions, noise):
    """NumPy float64 rollout with the engine's auto-reset, row by row.

    actions [T, B, ...], noise [T, 2, B] (xi, eta). Returns [T, B] arrays of
    reward, done, harvest, quota and the observation the policy sees next.
    """
    import numpy as np

    from gym_fishing_tpu.oracle import oracle as orc

    T, B = actions.shape[:2]
    out = {k: np.zeros((T, B)) for k in ("reward", "harvest", "quota", "obs")}
    out["done"] = np.zeros((T, B), bool)
    for b in range(B):
        st = orc.reset(cfg)
        for t in range(T):
            st, obs, r, done, info = orc.step_xi(
                cfg, st, actions[t, b], noise[t, 0, b], noise[t, 1, b])
            if done:
                st = orc.reset(cfg)
                obs = orc.get_obs(cfg, st.stock)
            out["reward"][t, b] = r
            out["done"][t, b] = done
            out["harvest"][t, b] = info["harvest"]
            out["quota"][t, b] = info["quota"]
            out["obs"][t, b] = obs[0]
    return out


def check_engine_against_oracle(dev, env_id: str, rows: int, steps: int,
                                seed: int = 0) -> dict:
    """The stepping program on ``rows`` envs in float64 vs the NumPy oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.policies import escapement
    from gym_fishing_tpu.batch import batched_reset
    from gym_fishing_tpu.bench.throughput import stepping_program

    with jax.enable_x64(True), jax.default_device(dev):
        env, params = gft.make(env_id, dtype=jnp.float64, sigma=0.05)
        pol = escapement(env, params)
        key = jax.random.key(seed)
        state = batched_reset(env, params, rows)
        summed = jax.jit(stepping_program(env, params, pol, steps))
        traced = jax.jit(stepping_program(env, params, pol, steps, True))
        s_sum, rew_sum = summed(state, key)
        s_tr, traj = traced(state, key)
        # the draws batched_step makes from each step's key
        noise = jax.jit(jax.vmap(
            lambda k: jax.random.normal(k, (2, rows), jnp.float64)
        ))(jax.random.split(key, steps))
        traj, noise = jax.device_get((traj, noise))
        s_sum, s_tr, rew_sum = jax.device_get((s_sum, s_tr, rew_sum))

    cfg = oracle_config(env, jax.device_get(params))
    ref = oracle_rollout(cfg, np.asarray(traj.action), np.asarray(noise))
    res = {"env_id": env_id, "rows": rows, "steps": steps,
           "episodes_ended": int(ref["done"].sum())}
    for k in ("reward", "harvest", "quota"):
        res[f"{k}_max_abs_diff"] = float(
            np.max(np.abs(np.asarray(getattr(traj, k)) - ref[k])))
    res["obs_max_abs_diff"] = float(
        np.max(np.abs(np.asarray(traj.obs)[..., 0] - ref["obs"])))
    res["done_equal"] = bool(np.array_equal(np.asarray(traj.done), ref["done"]))
    # the summed program is the trajectory program without its buffers
    res["programs_state_max_abs_diff"] = float(max(
        np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
        for a, b in zip(jax.tree.leaves(s_sum), jax.tree.leaves(s_tr))))
    res["programs_reward_sum_diff"] = float(
        abs(float(rew_sum) - float(np.sum(traj.reward))))
    res["atol"] = ORACLE_ATOL
    assert res["done_equal"], res
    for k in ("reward", "harvest", "quota", "obs", "programs_state"):
        assert res[f"{k}_max_abs_diff"] <= ORACLE_ATOL, (k, res)
    assert res["programs_reward_sum_diff"] <= ORACLE_ATOL * rows * steps, res
    return res


def phase_engine(dev, num_envs: int = 1 << 21, num_steps: int = 512,
                 reps: int = 3, oracle_rows: int = 4096,
                 oracle_steps: int = 120) -> dict:
    """Phase 1: stepping throughput in float32, then float64 vs the oracle."""
    import jax
    import numpy as np

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.policies import escapement
    from gym_fishing_tpu.batch import batched_reset
    from gym_fishing_tpu.bench.throughput import stepping_program

    env, params = gft.make("fishing-v1", sigma=0.05)
    pol = escapement(env, params)
    run = jax.jit(stepping_program(env, params, pol, num_steps))
    with jax.default_device(dev):
        state = batched_reset(env, params, num_envs)
        key = jax.random.key(0)
        compiled = run.lower(state, key).compile()
        mem = _memory(compiled)
        log("engine memory_analysis:", json.dumps(mem))
        sec, (state2, rew) = _timed(compiled, state, key, reps=reps)
        state2, rew = jax.device_get((state2, rew))
    stock = np.asarray(state2.env.stock)
    assert np.isfinite(float(rew)) and np.all(np.isfinite(stock)), "non-finite"
    assert np.all(stock >= 0.0), "negative stock"
    out = {
        "num_envs": num_envs, "num_steps": num_steps, "dtype": "float32",
        "seconds_per_call": sec,
        "env_steps_per_s": num_envs * num_steps / sec,
        "mean_reward_per_step": float(rew) / (num_envs * num_steps),
        "memory_analysis": mem,
    }
    log("engine float32:", json.dumps(out))
    for env_id in ("fishing-v1", "fishing-may-v1"):
        res = check_engine_against_oracle(dev, env_id, oracle_rows, oracle_steps)
        log("engine float64 vs oracle:", json.dumps(res))
        out[f"oracle_{env_id}"] = res
    return out


# ------------------------------------------------------------------- PPO
def _ppo_setup(env_id: str, cfg, dev, precision: str = "highest",
               seed: int = 0):
    """(env, params, ts, bstate, key) of one seed, built on ``dev``, with the
    MLP's matmuls at ``precision``."""
    import jax

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.ppo import make_network, make_train_state
    from gym_fishing_tpu.batch import batched_reset

    env, params = gft.make(env_id, sigma=0.05)
    net = dataclasses.replace(make_network(env, cfg), precision=precision)
    with jax.default_device(dev):
        k_init, k_step = jax.random.split(jax.random.key(seed))
        ts = make_train_state(env, cfg, k_init).replace(apply_fn=net.apply)
        bstate = batched_reset(env, params, cfg.num_envs)
    return env, params, ts, bstate, k_step


def one_iteration(env_id: str, cfg, dev, init_dev=None,
                  precision: str = "highest"):
    """One jitted ``train_step`` on ``dev``, fetched to the host.

    The initial state is built on ``init_dev`` (default ``dev``) and copied
    to ``dev``, so runs on two devices start from the same bits.
    """
    import jax

    from gym_fishing_tpu.agents.ppo import train_step

    env, params, ts, bstate, key = _ppo_setup(env_id, cfg, init_dev or dev,
                                              precision)
    step = jax.jit(partial(train_step, env, params, cfg))
    with jax.default_device(dev):
        return jax.device_get(step(*jax.device_put((ts, bstate, key), dev)))


def _diff(a, b) -> float:
    import jax
    import numpy as np

    return float(max(
        np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))))


def _bitwise(a, b) -> bool:
    import jax
    import numpy as np

    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def backend_differences(env_id: str, cfg, dev, ref_dev) -> dict:
    """Where two backends part, on one step's worth of inputs.

    threefry's bits must be equal. The normal draws (an erfinv transform)
    and the policy forward (tanh, and exp in the log-probs) go through each
    backend's own elementwise math, which may round differently.
    """
    import jax
    import jax.numpy as jnp

    _, _, ts, _, key = _ppo_setup(env_id, cfg, ref_dev)
    outs = []
    for d in (dev, ref_dev):
        t, k = jax.device_put((ts, key), d)
        with jax.default_device(d):
            obs = jax.random.uniform(k, (cfg.num_envs, 1), jnp.float32, -1.0, 1.0)
            dist, value = jax.jit(t.apply_fn)(t.params, obs)
            outs.append(jax.device_get((
                jax.random.bits(k, (2, cfg.num_envs)),
                jax.random.normal(k, (2, cfg.num_envs), jnp.float32),
                obs, dist[0], value)))
    (b_d, n_d, o_d, h_d, v_d), (b_r, n_r, o_r, h_r, v_r) = outs
    res = {
        "threefry_bits_bitwise": _bitwise(b_d, b_r),
        "normal_max_abs_diff": _diff(n_d, n_r),
        "uniform_bitwise": _bitwise(o_d, o_r),
        "policy_head_max_abs_diff": _diff(h_d, h_r),
        "value_max_abs_diff": _diff(v_d, v_r),
    }
    assert res["threefry_bits_bitwise"], res
    return res


def check_ppo_reference(env_id: str, cfg, dev, ref_dev):
    """One iteration at "highest" on ``dev`` vs the same on ``ref_dev``.

    Both start from the same bits (built on ``ref_dev``). threefry gives
    both backends the same random bits, but each backend has its own tanh,
    exp, log and erfinv, which round differently in the last place; the
    policy's actions, and through them the env states, differ by a few
    float32 ulps (``backend_differences`` shows where), and the backends
    sum the minibatch gradients in different orders. So the env states
    after the rollout are held to PPO_STATE_ATOL (bitwise equality is
    reported), the parameters after the 4x8 Adam steps to PPO_PARAMS_ATOL
    and the loss to PPO_LOSS_RTOL. Each limit sits between two readings at
    config 5 on an H100: the sound float32 run, and the same iteration with
    the MLP's matmuls at TF32 (PERF.md lists both), so a lower precision
    fails every one of them. Returns the comparison, the card's and the
    reference's ``(ts, bstate, metrics)``.
    """
    import jax

    with jax.default_matmul_precision("highest"):
        res = backend_differences(env_id, cfg, dev, ref_dev)
        card = ts_d, b_d, m_d = one_iteration(env_id, cfg, dev, ref_dev)
        ref = ts_r, b_r, m_r = one_iteration(env_id, cfg, ref_dev)
    loss_d, loss_r = float(m_d["loss"]), float(m_r["loss"])
    res.update({
        "env_state_bitwise": _bitwise(b_d, b_r),
        "env_state_max_abs_diff": _diff(b_d, b_r),
        "env_state_atol": PPO_STATE_ATOL,
        "params_max_abs_diff": _diff(ts_d.params, ts_r.params),
        "params_atol": PPO_PARAMS_ATOL,
        "loss": loss_d,
        "loss_ref": loss_r,
        "loss_rel_diff": abs(loss_d - loss_r) / max(abs(loss_r), 1e-30),
        "loss_rtol": PPO_LOSS_RTOL,
    })
    assert res["env_state_max_abs_diff"] <= PPO_STATE_ATOL, res
    assert res["params_max_abs_diff"] <= PPO_PARAMS_ATOL, res
    assert res["loss_rel_diff"] <= PPO_LOSS_RTOL, res
    return res, card, ref


def precision_gap(run, hi, ref) -> dict:
    """How far ``run`` (one iteration at another precision) lies from the
    card's "highest" run ``hi`` and the reference ``ref``, and whether it
    would pass each of check_ppo_reference's limits."""
    loss, loss_ref = float(run[2]["loss"]), float(ref[2]["loss"])
    res = {
        "env_state_max_abs_diff_vs_highest": _diff(hi[1], run[1]),
        "params_max_abs_diff_vs_highest": _diff(hi[0].params, run[0].params),
        "loss_highest": float(hi[2]["loss"]),
        "loss": loss,
        "env_state_max_abs_diff_vs_ref": _diff(ref[1], run[1]),
        "params_max_abs_diff_vs_ref": _diff(ref[0].params, run[0].params),
        "loss_rel_diff_vs_ref": abs(loss - loss_ref) / max(abs(loss_ref), 1e-30),
    }
    res["would_pass"] = {
        "env_state_atol": res["env_state_max_abs_diff_vs_ref"] <= PPO_STATE_ATOL,
        "params_atol": res["params_max_abs_diff_vs_ref"] <= PPO_PARAMS_ATOL,
        "loss_rtol": res["loss_rel_diff_vs_ref"] <= PPO_LOSS_RTOL,
    }
    return res


def phase_split(env_id: str, cfg, dev, precision: str = "highest",
                reps: int = 3) -> dict:
    """Seconds of the iteration's three pieces, each jitted on its own."""
    import jax

    from gym_fishing_tpu.agents.ppo import (
        build_batch, collect_rollout, train_step, update,
    )

    env, params, ts, bstate, key = _ppo_setup(env_id, cfg, dev, precision)
    continuous = env.config.scheme == "continuous"
    obs_dim = env.observation_space.shape[0]
    roll = jax.jit(partial(collect_rollout, env, params, cfg))
    pack = jax.jit(partial(build_batch, cfg))
    upd = jax.jit(lambda t, p, k: update(cfg, t, p, k, obs_dim, continuous))
    full = jax.jit(partial(train_step, env, params, cfg))
    with jax.default_device(dev):
        t_roll, (_, _, traj, last_value) = _timed(roll, ts, bstate, key, reps=reps)
        t_pack, packed = _timed(pack, traj, last_value, reps=reps)
        t_upd, _ = _timed(upd, ts, packed, key, reps=reps)
        full = full.lower(ts, bstate, key).compile()
        mem = _memory(full)
        t_full, _ = _timed(full, ts, bstate, key, reps=reps)
    samples = cfg.num_envs * cfg.num_steps
    return {
        "rollout_ms": t_roll * 1e3, "gae_and_packing_ms": t_pack * 1e3,
        "update_epochs_ms": t_upd * 1e3, "sum_of_pieces_ms":
        (t_roll + t_pack + t_upd) * 1e3, "train_step_ms": t_full * 1e3,
        "trained_env_steps_per_s": samples / t_full,
        "train_step_memory_analysis": mem,
    }


def phase_ppo(dev, ref_dev, num_envs: int = 16384, num_steps: int = 128,
              iterations: int = 3, reps: int = 3) -> dict:
    """Phase 2: BASELINE config 5 on ``dev``, checked against ``ref_dev``."""
    import jax
    import numpy as np

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents import ppo

    env_id = "fishing-v1"
    cfg = ppo.PPOConfig(num_envs=num_envs, num_steps=num_steps, epochs=4,
                        num_minibatches=8, hidden=64)
    out = {"config": dataclasses.asdict(cfg)}

    out["reference"], hi, ref = check_ppo_reference(env_id, cfg, dev, ref_dev)
    log("ppo card vs cpu at highest:", json.dumps(out["reference"]))

    env, params = gft.make(env_id, sigma=0.05)
    with jax.default_device(dev):
        _, hist = ppo.train(env, cfg, seed=0, iterations=iterations,
                            env_params=params)
    for h in hist:
        assert all(np.isfinite(h[k]) for k in ("loss", "pg_loss", "v_loss")), h
    out["train"] = hist
    log("ppo train:", json.dumps(hist))

    lo = one_iteration(env_id, cfg, dev, ref_dev, precision="default")
    out["default_precision_gap"] = precision_gap(lo, hi, ref)
    log("ppo default vs highest precision:", json.dumps(out["default_precision_gap"]))

    for prec in ("highest", "default"):
        split = phase_split(env_id, cfg, dev, prec, reps=reps)
        out[f"split_{prec}"] = split
        log(f"ppo phase split ({prec}):", json.dumps(split))
    return out


# -------------------------------------------------------------------- DP
def numpy_value_iteration(P, R, gamma: float, tol: float,
                          max_iters: int = 100_000):
    """Float64 value iteration with agents.dp's stopping rule."""
    import numpy as np

    P = np.asarray(P, np.float64)
    R = np.asarray(R, np.float64)
    A, S, _ = P.shape
    P2 = P.reshape(A * S, S)
    stop = tol * (1.0 - gamma) / gamma
    V = np.zeros(S)
    for i in range(max_iters):
        Vn = (R + gamma * (P2 @ V).reshape(A, S)).max(axis=0)
        Vn[0] = 0.0
        resid = np.max(np.abs(Vn - V))
        V = Vn
        if resid <= stop:
            break
    Q = R + gamma * (P2 @ V).reshape(A, S)
    return V, Q, i + 1


def phase_dp(dev, n_states: int = 257, n_quotas: int = 129,
             gamma: float = 0.995, tol: float = 1e-6) -> dict:
    """Phase 3: value_iteration on the card vs float64 NumPy on its MDP.

    The card solves in float32. Its V is held to DP_V_ATOL of the float64
    solution of the same (P, R): float32 rounds each sweep to ~1e-7
    relative, and the discounted sum carries that error by up to
    1/(1 - gamma). The greedy policy must be optimal under the float64 Q
    to the same tolerance.
    """
    import jax
    import numpy as np

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.dp import build_mdp, value_iteration

    env, params = gft.make("fishing-v1", sigma=0.05)
    with jax.default_device(dev):
        mdp = build_mdp(env, params, n_states=n_states, n_quotas=n_quotas)
        t0 = time.perf_counter()
        sol = jax.device_get(value_iteration(env, params, gamma=gamma, tol=tol,
                                             mdp=mdp))
        sec = time.perf_counter() - t0
        mdp = jax.device_get(mdp)
    V_ref, Q_ref, it_ref = numpy_value_iteration(mdp.P, mdp.R, gamma, tol)
    a_idx = np.searchsorted(np.asarray(mdp.quotas), np.asarray(sol.policy_quota))
    q_greedy = Q_ref[a_idx, np.arange(n_states)]
    res = {
        "n_states": n_states, "n_quotas": n_quotas, "gamma": gamma,
        "dtype": str(np.asarray(sol.V).dtype),
        "sweeps": int(sol.iterations), "residual": float(sol.residual),
        "sweeps_float64": it_ref, "seconds_with_compile": sec,
        "V_max_abs_diff": float(np.max(np.abs(np.asarray(sol.V) - V_ref))),
        "greedy_policy_max_loss": float(np.max(V_ref - q_greedy)),
        "atol": DP_V_ATOL,
    }
    assert np.all(np.isfinite(np.asarray(sol.V))), res
    assert res["V_max_abs_diff"] <= DP_V_ATOL, res
    assert res["greedy_policy_max_loss"] <= DP_V_ATOL, res
    log("dp value_iteration vs float64:", json.dumps(res))
    return res


# ------------------------------------------------------------- multichip
def phase_multichip(devices, envs_per_device: int = 16384,
                    num_steps: int = 128, reps: int = 3) -> dict:
    """Phase 4: GSPMD train_step over ``devices`` vs the global batch on one."""
    import jax

    import gym_fishing_tpu as gft
    from gym_fishing_tpu.agents.ppo import PPOConfig, make_train_state, train_step
    from gym_fishing_tpu.batch import batched_reset
    from gym_fishing_tpu.shard import compare_sharded, make_mesh, replicate, shard_batch

    n = len(devices)
    cfg = PPOConfig(num_envs=envs_per_device * n, num_steps=num_steps)
    with jax.default_matmul_precision("highest"):
        res = compare_sharded("fishing-v1", cfg, devices)
    log("multichip sharded vs one card:", json.dumps(res))

    env, params = gft.make("fishing-v1", sigma=0.05)
    step = jax.jit(partial(train_step, env, params, cfg))
    mesh = make_mesh(devices=devices)
    with jax.default_device(devices[0]):
        key = jax.random.key(0)
        ts = make_train_state(env, cfg, key)
        b = batched_reset(env, params, cfg.num_envs)
        t_one, _ = _timed(step, ts, b, key, reps=reps)
    t_n, _ = _timed(step, replicate(ts, mesh), shard_batch(b, mesh), key, reps=reps)
    res.update({
        "train_step_ms_one_device": t_one * 1e3,
        f"train_step_ms_{n}_devices": t_n * 1e3,
        "speedup": t_one / t_n,
    })
    log("multichip timing:", json.dumps(res))
    assert res["ok"], res
    return res


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the sharded learner over four cards")
    args = ap.parse_args(argv)

    import jax

    from gym_fishing_tpu import device

    n = 4 if args.multichip else 1
    try:
        gpus = device.require("gpu", n)
    except device.DeviceUnavailable as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    device.setup_compile_cache()
    log("optional packages:", json.dumps(optional_packages()))
    log("jax", jax.__version__, "devices:", json.dumps(device.describe(jax.devices())))
    log("nvidia-smi name, power.limit:", device.gpu_name_and_power_limit())
    if args.multichip:
        phase_multichip(gpus)
    else:
        phase_engine(gpus[0])
        phase_ppo(gpus[0], jax.devices("cpu")[0])
        phase_dp(gpus[0])
    log(json.dumps({"ok": True, "device": device.describe(jax.devices())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
