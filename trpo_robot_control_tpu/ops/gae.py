"""Generalised Advantage Estimation as a parallel suffix scan (SURVEY.md
section 3 "GAE estimator"): the GAE recurrence
a_t = delta_t + (gamma*lam)*nonterm_t * a_{t+1} is a first-order linear
recurrence, i.e. a composition of affine maps x -> d + c*x — associative,
so `lax.associative_scan` evaluates all T suffixes in O(log T) steps
instead of a T-step sequential `lax.scan`, whose per-step loop overhead
would dominate its tiny per-step arithmetic.

Termination: `dones` (N, T) marks steps whose POST-step state ended the
episode (early success termination with auto-reset, and always t = T-1 —
no bootstrap past a done flag). When `dones` is None, episodes are
fixed-horizon with termination only at t = T-1, matching
oracle/trpo.py:gae exactly (up to fp32 reassociation of the suffix
products; the parity suites bound the difference).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _affine_compose(f, g):
    """(g o f) for affine maps represented as (c, d): x -> d + c*x.

    associative_scan(reverse=True) folds elements with the LATER timestep
    as the left operand, so combining (f, g) must apply f first:
    x -> dg + cg*(df + cf*x)."""
    cf, df = f
    cg, dg = g
    return cf * cg, dg + cg * df


def _nonterm(rewards, dones, time_axis: int = 1):
    if dones is None:
        T = rewards.shape[time_axis]
        ones = jnp.ones(T, rewards.dtype).at[-1].set(0.0)
        shape = [1, 1]
        shape[time_axis] = T
        return jnp.broadcast_to(ones.reshape(shape), rewards.shape)
    return 1.0 - dones.astype(rewards.dtype)


def gae(rewards, values, gamma: float, lam: float, dones=None,
        time_axis: int = 1):
    """rewards/values (N, T) [, dones (N, T)] -> raw advantages (N, T).

    time_axis=0 runs the identical recurrence on (T, N) operands — the
    fused rollout kernels' native layout (batch["rewards_ff"]), so the
    ff update path never materialises a transposed rewards/advantage
    copy (trpo/update.py). Same math: the scan combines along time and
    every other op is elementwise."""
    nonterm = _nonterm(rewards, dones, time_axis)
    if time_axis == 1:
        next_v = jnp.concatenate(
            [values[:, 1:], jnp.zeros_like(values[:, :1])], axis=1)
    else:
        next_v = jnp.concatenate(
            [values[1:], jnp.zeros_like(values[:1])], axis=0)
    delta = rewards + gamma * next_v * nonterm - values
    coeff = (gamma * lam) * nonterm
    # a_t = (T_t o T_{t+1} o ... o T_{T-1})(0) with T_t: x -> delta_t + c_t*x
    _, adv = jax.lax.associative_scan(_affine_compose, (coeff, delta),
                                      reverse=True, axis=time_axis)
    return adv


def returns_to_go(rewards, gamma: float, dones=None):
    """Discounted returns-to-go (diagnostics), same termination rule."""
    nonterm = _nonterm(rewards, dones)
    _, ret = jax.lax.associative_scan(
        _affine_compose, (gamma * nonterm, rewards), reverse=True, axis=1)
    return ret
