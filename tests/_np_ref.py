"""Plain NumPy float64 references for the PPO learner's pieces (not a test module).

Written from the algorithms' definitions, sharing no code with
``gym_fishing_tpu.agents``: the actor-critic forward pass, the action
log-probabilities, GAE by a reverse Python loop, and one Adam step after
clipping by global norm.
"""

import numpy as np


def _f64(x):
    return np.asarray(x, np.float64)


def forward(params, obs, continuous):
    """(head, log_std or None, value): head is the mean or the logits."""
    p = params["params"]

    def dense(x, name):
        return x @ _f64(p[name]["kernel"]) + _f64(p[name]["bias"])

    def mlp(x, name):
        return np.tanh(dense(np.tanh(dense(x, f"{name}_d1")), f"{name}_d2"))

    obs = _f64(obs)
    pi, v = mlp(obs, "pi"), mlp(obs, "v")
    value = dense(v, "v_out")[..., 0]
    if continuous:
        return dense(pi, "pi_mean"), _f64(p["log_std"]), value
    return dense(pi, "pi_logits"), None, value


def logp(head, log_std, action, continuous):
    """Log-probability of ``action`` under the policy head."""
    if continuous:
        a = _f64(action)
        var = np.exp(2 * log_std)
        return np.sum(
            -0.5 * ((a - head) ** 2 / var + 2 * log_std + np.log(2 * np.pi)),
            axis=-1,
        )
    z = head - head.max(axis=-1, keepdims=True)
    logps = z - np.log(np.exp(z).sum(axis=-1, keepdims=True))
    idx = np.asarray(action).astype(int)
    return np.take_along_axis(logps, idx[..., None], axis=-1)[..., 0]


def gae(rewards, values, dones, last_value, gamma, lam):
    """Advantages and returns by a reverse loop over [T, B] arrays."""
    rewards, values = _f64(rewards), _f64(values)
    dones = np.asarray(dones, bool)
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    running = np.zeros_like(rewards[0])
    next_value = _f64(last_value)
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        running = delta + gamma * lam * nonterminal * running
        adv[t] = running
        next_value = values[t]
    return adv, adv + values


def clipped_adam_first_step(params, grads, lr, max_norm, eps, b1=0.9, b2=0.999):
    """Params after one Adam step (from zero moments) on norm-clipped grads."""
    leaves = [_f64(g) for g in grads]
    norm = np.sqrt(sum(np.sum(g * g) for g in leaves))
    scale = min(1.0, max_norm / norm) if norm > 0 else 1.0
    out = []
    for p, g in zip(params, leaves):
        g = g * scale
        m_hat = (1 - b1) * g / (1 - b1)
        v_hat = (1 - b2) * g * g / (1 - b2)
        out.append(_f64(p) - lr * m_hat / (np.sqrt(v_hat) + eps))
    return out
